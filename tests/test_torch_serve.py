"""The port's serving layer (ha2g_torch/serve.py) on the CPU, mirroring
tests/test_serve.py: micro-batched requests against the JAX package's
``generate`` on the same padded batch (1e-4), padding rows that leave a
real row as it is, the HTTP API with every encoding and its error paths,
live streams over HTTP with their caps, the stream batcher, a failed
batch reported as an error; and ``kernels.load`` building once when
threads race.  TED Gesture, hidden 16, 2 GRU layers, fp32, speaker z
pinned at mu (tests/test_torch_bridge.py builds the weights)."""

import base64
import ctypes
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu.synthesis import HierarchySynthesizer as JaxSynthesizer
from tests.test_torch_bridge import (N_SPK, jax_hierarchy, jax_state_dict,
                                     port_config, vocabs)
from tests.torch_serving import (http_server,  # noqa: F401  (fixture)
                                 no_thread_outlives_module)

from ha2g_torch import kernels
from ha2g_torch.checkpoint import save_checkpoint
from ha2g_torch.ops.mel import mulaw_encode_np
from ha2g_torch.serve import GestureService
from ha2g_torch.synthesis import _window_layout
from ha2g_torch.train.hierarchy import HierarchySystem

SR = 16000
# service rows against JAX generate: fp32 in two frameworks
ATOL = 1e-4
# one row alone against the same row among padding rows, and a batched
# stream window against the stream alone: the batch size changes the
# shapes of the products, so the CPU's sums may round differently
BATCH_ATOL = 1e-5


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    _, _, state = jax_hierarchy("ted_gesture", 27)
    _, (lang, speaker) = vocabs()
    port = HierarchySystem(port_config("ted_gesture", 27), lang.n_words,
                           N_SPK, device="cpu")
    port.load_state_dict(jax_state_dict(state), strict=True)
    path = tmp_path_factory.mktemp("serve") / "checkpoint"
    save_checkpoint(path, port, port.cfg, lang, speaker)
    return str(path)


@pytest.fixture(scope="module")
def service(checkpoint):
    svc = GestureService(checkpoint, max_clip_seconds=4.0, max_batch=8,
                         batch_window_ms=300.0, warm=False, device="cpu")
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def http(service):
    with http_server(service) as url:
        yield url


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=int(seconds * SR)) * 0.1).astype(np.float32)


def _post(url, obj, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(url, data: bytes = None):
    try:
        urllib.request.urlopen(urllib.request.Request(url, data=data),
                               timeout=60)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _poses(resp):
    dt = "<f2" if resp["dtype"] == "f16" else "<f4"
    return np.frombuffer(base64.b64decode(resp["dir_vec"]), dt) \
        .reshape(resp["shape"]).astype(np.float32)


def _wait(reqs):
    for r in reqs:
        assert r.done.wait(600) and r.error is None, r.error


def test_requests_micro_batch_and_match_jax_generate(service):
    """Requests that arrive together run as one call per loop (host and
    fused), padded to a bucket with silent rows; each response is its row
    of the JAX package's ``generate`` on the same padded batch.  (Full
    4 s clips: where a clip ends in silence, the -80 dB floor drives the
    random-weight audio encoder far out of range and both packages'
    rounding grows past 1e-4 there; that tail is held to the port's own
    batch path in the next test.)"""
    _, jsystem, jstate = jax_hierarchy("ted_gesture", 27)
    (jlang, _), _ = vocabs()
    jsynth = JaxSynthesizer(jsystem, jstate)
    before = dict(service.stats)
    specs = [(4.0, False), (4.0, False), (4.0, False), (4.0, True),
             (4.5, True)]
    reqs = [service.submit(_audio(s, i), [("w1", 0.2, 0.5), ("w4", 1.0, 1.2)],
                           vid=i % N_SPK, fused=fused)
            for i, (s, fused) in enumerate(specs)]
    _wait(reqs)
    assert service.stats["batches"] - before["batches"] == 2
    assert service.stats["requests"] - before["requests"] == 5
    assert reqs[4].truncated_from == 4.5
    for group in (reqs[:3], reqs[3:]):
        audio, words, vids = service.padded_batch(group)
        assert audio.shape == (4, 4 * SR)
        want = jsynth.generate(audio, words, jlang, vids)
        for i, r in enumerate(group):
            assert r.result.shape == (60, 27)
            np.testing.assert_allclose(r.result, want[i, :60], atol=ATOL,
                                       rtol=0)


def test_responses_are_rows_of_the_padded_batch(service):
    """Shorter requests: each response is its row of the port's own
    ``generate`` on the padded batch, cut to the request's length; and a
    request alone (bucket 1) answers as it does beside others (bucket 4):
    batch norm runs in eval mode, so padding rows change no real row."""
    words = [("w2", 0.5, 0.7)]
    reqs = [service.submit(_audio(s, 10 + i), words, vid=1, fused=False)
            for i, s in enumerate((3.0, 1.2, 2.5))]
    _wait(reqs)
    audio, pad_words, vids = service.padded_batch(reqs)
    want = service.synth.generate(audio, pad_words, service.lang, vids)
    for i, r in enumerate(reqs):
        n = int(round(len(r.audio) / SR * service.fps))
        assert r.result.shape == (n, 27)
        np.testing.assert_allclose(r.result, want[i, :n], atol=BATCH_ATOL,
                                   rtol=0)
    alone = service.synthesize(reqs[0].audio, words, vid=1, fused=False)
    np.testing.assert_allclose(reqs[0].result, alone, atol=BATCH_ATOL,
                               rtol=0)


def test_http_every_encoding(service, http):
    """pcm_f32 / pcm_i16 / pcm_mulaw requests, f32 and f16 responses."""
    with urllib.request.urlopen(f"{http}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["pose_dim"] == 27 and health["fps"] == 15
    wave = _audio(1.0, 5)

    def post(raw, encoding, return_dtype="f32"):
        resp = _post(f"{http}/synthesize", {
            "audio": base64.b64encode(raw).decode(), "encoding": encoding,
            "return_dtype": return_dtype, "words": [["w1", 0.1, 0.3]],
            "vid": 0, "fused": False})
        assert resp["dtype"] == return_dtype and resp["fps"] == 15
        assert resp["covered_seconds"] == 1.0 and not resp["truncated"]
        return _poses(resp)

    ref = post(wave.astype("<f4").tobytes(), "pcm_f32")
    direct = service.synthesize(wave, [("w1", 0.1, 0.3)], fused=False)
    np.testing.assert_array_equal(ref, direct)
    i16 = post((wave * 32768.0).astype("<i2").tobytes(), "pcm_i16")
    u8 = post(mulaw_encode_np(wave).tobytes(), "pcm_mulaw")
    f16 = post(wave.astype("<f4").tobytes(), "pcm_f32", "f16")
    assert ref.shape == i16.shape == u8.shape == f16.shape == (15, 27)
    np.testing.assert_allclose(i16, ref, atol=2e-3)
    np.testing.assert_allclose(u8, ref, atol=3e-2)
    np.testing.assert_allclose(f16, ref, atol=1e-3 * np.abs(ref).max())
    listed = _post(f"{http}/synthesize", {"audio": wave[:8000].tolist()})
    assert listed["shape"] == [8, 27]
    with urllib.request.urlopen(f"{http}/stats", timeout=60) as r:
        stats = json.loads(r.read())
    assert stats["errors"] == 0 and stats["requests"] >= 5


def test_http_error_paths(http):
    assert _status(f"{http}/synthesize", b"not json") == 500
    assert _status(f"{http}/synthesize", json.dumps({"vid": 0}).encode()) \
        == 500
    assert _status(f"{http}/synthesize", json.dumps(
        {"audio": [0.0] * 100, "return_dtype": "f64"}).encode()) == 500
    assert _status(f"{http}/nowhere", b"{}") == 404
    assert _status(f"{http}/nowhere") == 404
    assert _status(f"{http}/stream/abc/rewind", b"{}") == 404


def test_http_live_stream(service, http):
    sid = _post(f"{http}/stream/open", {"vid": 0})["stream_id"]
    audio = _audio(3.0, 3)
    r1 = _post(f"{http}/stream/{sid}/feed", {
        "audio": base64.b64encode((audio * 32767).astype("<i2").tobytes())
        .decode(), "encoding": "pcm_i16", "words": [["w1", 0.3, 0.6]]})
    r2 = _post(f"{http}/stream/{sid}/finish", {"return_dtype": "f16"})
    _, _, num = _window_layout(service.cfg, 3.0)
    assert r1["shape"][0] + r2["shape"][0] == 34 + (num - 1) * 30
    assert np.isfinite(_poses(r1)).all() and np.isfinite(_poses(r2)).all()
    # a finished stream is gone
    assert _status(f"{http}/stream/{sid}/feed", b"{}") == 404
    assert _status(f"{http}/stream/{sid}/finish", b"{}") == 404


def test_stream_caps_and_expiry(service, monkeypatch):
    sid = service.open_stream(vid=0)
    with pytest.raises(ValueError, match="max_stream_seconds"):
        service.stream_feed(sid, np.zeros(
            int(service.max_stream_seconds * SR) + 1, np.float32))
    monkeypatch.setattr(service, "max_streams", len(service._streams))
    with pytest.raises(RuntimeError, match="too many live streams"):
        service.open_stream(vid=0)
    monkeypatch.setattr(service, "max_streams", 32)
    service.stream_finish(sid)
    with pytest.raises(KeyError):
        service.stream_finish(sid)
    stale = service.open_stream(vid=0)
    monkeypatch.setattr(service, "stream_idle_timeout", 0.0)
    time.sleep(0.01)
    fresh = service.open_stream(vid=0)       # drops the idle one
    with pytest.raises(KeyError, match="idle-expired"):
        service.stream_feed(stale, np.zeros(100, np.float32))
    service.stream_finish(fresh)


def test_stream_batching_coalesces_windows(checkpoint):
    """Concurrent streams' windows run as shared calls, and each stream
    gives what it gives alone."""
    svc = GestureService(checkpoint, max_clip_seconds=4.0, max_batch=8,
                         warm=False, stream_batching=True,
                         stream_batch_window_ms=500.0, device="cpu")
    try:
        clips = [_audio(3.0, 20 + i) for i in range(3)]
        solo = []
        for c in clips:
            st = svc.synth.stream(svc.lang, vid=0, total_seconds=3.0)
            solo.append(np.concatenate([st.feed(c), st.finish()]))
        results = {}

        def run(i):
            sid = svc.open_stream(vid=0, total_seconds=3.0)
            results[i] = np.concatenate([
                svc.stream_feed(sid, clips[i][:SR]),
                svc.stream_feed(sid, clips[i][SR:]),
                svc.stream_finish(sid)])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive()
        for i in range(3):
            np.testing.assert_allclose(results[i], solo[i], atol=BATCH_ATOL,
                                       rtol=0, err_msg=f"stream {i}")
        assert svc.stats["stream_windows"] == 6
        assert svc.stats["stream_batches"] < svc.stats["stream_windows"]
    finally:
        svc.close()


def test_counters_hold_under_concurrent_streams(service):
    """Twelve threads open, feed and finish short streams with the
    interpreter switching threads as often as it can: no update of the
    shared counters is lost."""
    before = dict(service.stats)
    done = []

    def run(i):
        sid = service.open_stream(vid=i % N_SPK)
        frames = len(service.stream_feed(sid, _audio(0.3, 40 + i)))
        done.append(frames + len(service.stream_finish(sid)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert done == [34] * 12
    assert service.stats["streams_opened"] - before["streams_opened"] == 12
    assert service.stats["frames"] - before["frames"] == 12 * 34


def test_a_failed_batch_answers_with_its_error(service, monkeypatch):
    """Serving does not die: the batch's requests get the error, it is
    counted, and the next request is served."""
    errors = service.stats["errors"]

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed: CUDA error 700")

    monkeypatch.setattr(service.synth, "generate_fused", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        service.synthesize(_audio(1.0, 1), [])
    assert service.stats["errors"] == errors + 1
    monkeypatch.undo()
    assert service.synthesize(_audio(1.0, 1), []).shape == (15, 27)


def test_kernel_load_builds_once_when_threads_race(monkeypatch, tmp_path):
    """Eight threads that first use a kernel together build it once and
    share one library; a build's temporary file is named by process and
    thread."""
    source = tmp_path / "k.cu"
    source.write_text("// a kernel")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    commands = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            time.sleep(0.05)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(kernels.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(kernels, "_loaded", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        kernels.load(source))) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(commands) == 1
    assert len(got) == 8 and len(set(got)) == 1
    assert kernels.library_path(source).exists()
    tmp = Path(commands[0][commands[0].index("-o") + 1]).name
    assert any(tmp.endswith(f".{os.getpid()}.{t.ident}.tmp")
               for t in threads)
