"""Command line of the port (modelled on ha2g_tpu/cli.py):

  python -m ha2g_torch.cli train --config configs_expressive/hierarchy.yaml
      [--field value ...] [--resume CHECKPOINT] [--device cuda|cpu]
  torchrun --standalone --nproc_per_node N -m ha2g_torch.cli train
      --config ... [--fsdp_devices M] [--device cuda|cpu]
  python -m ha2g_torch.cli eval CHECKPOINT [--clips DIR] [--bc]
  python -m ha2g_torch.cli synthesize CHECKPOINT [--clips DIR] [--n N]
      [--out FILE] [--fused] [--fade_out]
  python -m ha2g_torch.cli from-text CHECKPOINT --text "..." --wav FILE
      [--out FILE]
  python -m ha2g_torch.cli serve CHECKPOINT [--host H] [--port P]
      [--max_clip_seconds S] [--max_batch N] [--batch_window_ms MS]
      [--stream_batching]
  python -m ha2g_torch.cli import-checkpoint REFERENCE.bin OUT_DIR
  python -m ha2g_torch.cli export-checkpoint CHECKPOINT OUT.bin
  python -m ha2g_torch.cli import-evalnet REFERENCE.bin OUT_DIR
  python -m ha2g_torch.cli import-lmdb SRC_LMDB DST [--format source|cache]
      [--limit N] [--n_poses N] [--fps F] [--max_words N]
      [--remove_word_timing]
  python -m ha2g_torch.cli import-embeddings MODEL.bin|.vec OUT.npy
      --config CONFIG [--dim D] [--field value ...]
  python -m ha2g_torch.cli motion-stats CLIPS [--dataset NAME] [--fps F]
  python -m ha2g_torch.cli angle-stats --config CONFIG [--field value ...]
  python -m ha2g_torch.cli parse-reference-log LOG [--out JSON]
  python -m ha2g_torch.cli compare-trajectory HISTORY.jsonl [--ref NAME|LOG]
      [--keys k,...] [--json OUT]
  python -m ha2g_torch.cli doctor [--device cuda|cpu]
  python -m ha2g_torch.cli build-dataset [IDS ...] [--video-ids FILE]
      --work DIR --out DIR [--fps F] [--min-shoulder-px PX] [--qa-report]
  python -m ha2g_torch.cli make-librosa-goldens [OUT.npz]

A CHECKPOINT is a directory written by the port (``state.pt``) or by the
JAX package (``state.msgpack``): synthesize, eval, from-text, serve and
export-checkpoint read either; ``train --resume`` needs the port's, which
carries the optimiser state.  The model families: hierarchy,
multimodal_context, speech2gesture, seq2seq, joint_embedding and
gesture_autoencoder (the FGD embedders' training: EmbeddingNet at pose 27,
MotionAE at 126; ``eval`` gives its reconstruction loss, and it has no
synthesis).  ``import-checkpoint`` turns a reference ``.bin`` (a
hierarchy's, or a baseline's generic one) into a port checkpoint,
``export-checkpoint`` writes a checkpoint as a reference ``.bin`` (a
trained gesture_autoencoder or an FGD embedder directory in the
evaluator's layout), and ``import-evalnet`` turns a reference FGD
embedder ``.bin`` into a directory ``eval_net_path`` can name.
``--fused`` (synthesize) is the hierarchy's fused loop; other models run
their window loop.  Live streams (``serve``) drive spectrogram-windowed
models (hierarchy, speech2gesture).  ``from-text`` needs ``--wav`` (16 kHz mono) and
spreads the words evenly over it (no TTS, no forced alignment).

Data paths in a config are a clip-storage directory (data/storage.py),
a directory of windowed samples (``samples.npz``, from ``import-lmdb
--format cache``), a Human3.6M ``.npz`` (``positions_3d``; the
gesture_autoencoder's windows, with ``embed_pose_diff_loss`` set), or
"synthetic" / "none" / empty, a built-in synthetic set; any other path
that does not exist raises, as does a named ``wordembed_path`` (a
fastText ``.bin``, text vectors ``.vec`` / ``.txt``, or a table aligned to
the vocabulary ``.npy``).  ``import-lmdb`` reads the reference's lmdb
stores (a source store into clip storage, a cache store into windowed
samples) with the port's own lmdb reader and pyarrow-0.14 codec;
``import-embeddings`` aligns a fastText model to a config's vocabulary.
``eval_net_path`` names an FGD embedder: a directory saved by
``checkpoint.save_embedder`` or ``import-evalnet``, or the
``checkpoint_best`` of a gesture_autoencoder run (the port's or the JAX
package's); without one the trainer selects checkpoints by the
validation loss.  The importers, the statistics and the trajectory
tools run on the host alone; every other command runs on CUDA unless
``--device cpu`` is given, and without CUDA and without it, raises.
``compare-trajectory`` exits 1 when a metric is BEHIND or the reference
too short (INSUFFICIENT_REF); ``doctor`` exits 0 only when the device, the
mel front-end and a tiny GAN step (kernels B1-B4 on the card) all hold.
``synthesize --render`` also draws the first clip's skeleton animation
beside ``--out`` (``render.py``: a GIF, or an MP4 with the audio where
ffmpeg exists).  ``build-dataset`` (host only) runs the dataset
construction over a work directory of the outside tools' artifacts
(``dataset_pipeline/``) into clip storage, exit 1 when no video was
built; ``make-librosa-goldens`` writes the mel / onset goldens with
librosa itself and fails without it.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _device(value: str):
    from ha2g_torch.device import resolve_device
    try:
        return resolve_device(value)
    except RuntimeError as err:
        raise RuntimeError(f"{err} (on the command line: --device cpu)") \
            from None


def _pop(argv: list[str], flag: str, default=None):
    """Remove ``flag value`` from argv; -> (value or default, argv)."""
    if flag not in argv:
        return default, argv
    i = argv.index(flag)
    return argv[i + 1], argv[:i] + argv[i + 2:]


def set_logger(log_path=None, name: str = "log") -> None:
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_path is not None:
        Path(log_path).mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(Path(log_path) / f"{name}.log"))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s: %(message)s",
                        handlers=handlers, force=True)


SYNTHETIC_PATHS = ("", "synthetic", "none")


def _load_split(path: Optional[str], cfg, seed: int):
    """The clips of a clip-storage directory, or, for a path in
    ``SYNTHETIC_PATHS``, a built-in synthetic set; a named directory that
    does not exist raises."""
    from ha2g_torch.data.storage import load_clips
    from ha2g_torch.data.synthetic import synthetic_clips
    if (path or "") not in SYNTHETIC_PATHS:
        if not Path(path).exists():
            raise FileNotFoundError(f"no clip set at {path!r} (for the "
                                    "built-in synthetic clips: 'synthetic')")
        return load_clips(path)
    n = {0: 24, 1: 8, 2: 8}[seed % 3]
    return synthetic_clips(cfg.skeleton, n_clips=n, clip_seconds=8.0,
                           n_speakers=6, seed=seed)


def _h36m_samples(cfg, is_train: bool):
    """Human3.6M windows as WindowedSamples with zero text and audio (the
    gesture autoencoder reads ``target`` alone; reference
    train_feature_extractor.py:110-131)."""
    from ha2g_torch.data.dataset import (WindowedSamples,
                                         spectrogram_length_for)
    from ha2g_torch.data.h36m import h36m_windows
    targets = h36m_windows(cfg.train_data_path, cfg.mean_dir_vec_array,
                           is_train=is_train, n_poses=cfg.n_poses)
    n, fps = targets.shape[0], cfg.motion_resampling_framerate
    audio_len = int(round(cfg.n_poses / fps * 16000))
    z = np.zeros
    return WindowedSamples(
        text=z((n, cfg.n_poses), np.int32),
        word_seq=z((n, 2), np.int32), word_lengths=np.full(n, 2, np.int32),
        pose=z((n, cfg.n_poses, 30), np.float32), target=targets,
        audio=z((n, audio_len), np.float32),
        spec=z((n, 128, spectrogram_length_for(cfg.n_poses, fps)),
               np.float32), vids=z((n,), np.int32))


def _word_vectors(cfg, lang) -> None:
    if cfg.wordembed_path:     # a missing file raises
        lang.load_word_vectors(cfg.wordembed_path, cfg.wordembed_dim)
    else:
        lang.random_word_vectors(cfg.wordembed_dim)


def _prepare(cfg, lang=None, speaker=None):
    """Load the train and eval data, build the vocabularies (or take the
    given ones, a checkpoint's), window the clips into samples.  The data:
    a Human3.6M ``.npz``, a directory of imported samples, or clips.
    -> (cfg, lang, speaker, train samples, val samples)."""
    from ha2g_torch.data.dataset import window_clips
    from ha2g_torch.data.lmdb_import import (has_imported_samples,
                                             load_imported_samples)
    from ha2g_torch.data.synthetic import default_mean_dir_vec
    from ha2g_torch.data.vocab import Vocab, build_vocab

    if cfg.train_data_path.endswith(".npz"):
        # the H36M feature extractor (train_feature_extractor.py): its
        # step adds the pose-difference L1 term (:68-71)
        cfg = cfg.replace(embed_pose_diff_loss=True)
        if lang is None:
            lang = Vocab("words")
            lang.random_word_vectors(cfg.wordembed_dim)
        if speaker is None:
            speaker = Vocab("vid", insert_default_tokens=False)
        return (cfg, lang, speaker, _h36m_samples(cfg, True),
                _h36m_samples(cfg, False))

    if has_imported_samples(cfg.train_data_path):
        # windows from `import-lmdb --format cache`
        train_s, own_lang, own_speaker = load_imported_samples(
            cfg.train_data_path)
        val_path = cfg.test_data_path or cfg.val_data_path
        if has_imported_samples(val_path):
            val_s = load_imported_samples(val_path)[0]
        else:
            logging.warning(
                "no imported validation samples found (%s): validating on "
                "the TRAINING set — per-epoch metrics and best-checkpoint "
                "selection will be optimistic; set test_data_path/"
                "val_data_path to an imported split", val_path or "<unset>")
            val_s = train_s
        if lang is None:
            lang = own_lang
            _word_vectors(cfg, lang)
        if speaker is None:
            speaker = own_speaker
        logging.info(f"imported samples: train {len(train_s)}, "
                     f"val {len(val_s)}, vocab {lang.n_words} words")
        return cfg, lang, speaker, train_s, val_s

    train_clips = _load_split(cfg.train_data_path, cfg, 0)
    # the reference validates on the test split (train.py:652-724)
    val_clips = _load_split(cfg.test_data_path or cfg.val_data_path, cfg, 1)
    if lang is None:
        lang = build_vocab("words", [train_clips, val_clips])
        _word_vectors(cfg, lang)
    if speaker is None:
        speaker = Vocab("vid", insert_default_tokens=False)
        for c in train_clips + val_clips:
            speaker.index_word(c["vid"])

    if cfg.mean_dir_vec is not None:
        mean_vec = cfg.mean_dir_vec_array
    else:
        mean_vec = default_mean_dir_vec(cfg.skeleton)
        cfg = cfg.replace(mean_dir_vec=[float(v) for v in mean_vec])
    mean_pose = cfg.mean_pose_array if cfg.mean_pose is not None else \
        np.zeros(cfg.skeleton.n_joints * 3, np.float32)
    static = (6, 7) if cfg.dataset == "ted_expressive" else (6, 9)
    kw = dict(spec=cfg.skeleton, lang=lang, speaker=speaker,
              mean_pose=mean_pose, mean_dir_vec=mean_vec,
              n_poses=cfg.n_poses, subdivision_stride=cfg.subdivision_stride,
              fps=cfg.motion_resampling_framerate, static_joints=static)
    train_samples = window_clips(train_clips, **kw)
    val_samples = window_clips(val_clips, **kw)
    logging.info(f"train samples: {len(train_samples)}, val: "
                 f"{len(val_samples)}, vocab: {lang.n_words} words, "
                 f"{speaker.n_words} speakers")
    return cfg, lang, speaker, train_samples, val_samples


def make_evaluator(cfg, device):
    """The frozen FGD embedder that ``eval_net_path`` names, or None."""
    from ha2g_torch.checkpoint import load_embedder
    from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator
    if not cfg.eval_net_path or not Path(cfg.eval_net_path).exists():
        logging.info("no FGD embedder at eval_net_path %r: checkpoints are "
                     "selected by the validation loss", cfg.eval_net_path)
        return None
    ev_cfg, state = load_embedder(cfg.eval_net_path)
    return EmbeddingSpaceEvaluator(ev_cfg.pose_dim, ev_cfg.n_poses, state,
                                   latent_dim=ev_cfg.latent_dim,
                                   device=device)


def cmd_train(argv: list[str]) -> int:
    """Train; under torchrun (``WORLD_SIZE`` > 1) as one rank of the mesh
    over every rank, ``--fsdp_devices`` of them sharding each parameter,
    on ``cuda:LOCAL_RANK`` (NCCL) or the CPU (gloo), logging to the file
    on rank 0 only."""
    import torch.distributed as dist

    from ha2g_torch.config import parse_cli
    from ha2g_torch.parallel.mesh import init_process_group, rank_device
    from ha2g_torch.train.loop import Trainer

    device, argv = _pop(argv, "--device", "cuda")
    resume, argv = _pop(argv, "--resume")
    device = _device(rank_device(device))
    cfg = parse_cli(argv)
    own_group = not dist.is_initialized() and init_process_group(device)
    if dist.is_initialized() and dist.get_rank() != 0:
        logging.basicConfig(level=logging.WARNING, force=True,
                            format="%(asctime)s: %(message)s")
    else:
        set_logger(cfg.model_save_path, cfg.name)
    logging.info(f"config: {cfg}")
    cfg, lang, speaker, train_s, val_s = _prepare(cfg)
    trainer = Trainer(cfg, train_s, val_s, lang, speaker,
                      make_evaluator(cfg, device), device=device)
    trainer.fit(resume_from=resume)
    logging.info(f"best: {trainer.best_values}")
    if own_group:
        dist.destroy_process_group()
    return 0


def load_checkpoint_system(checkpoint: str, device):
    """-> (cfg, lang, speaker, system) with the parameters of a port or a
    JAX checkpoint directory."""
    from ha2g_torch import checkpoint as ckpt
    from ha2g_torch.train.loop import build_system
    cfg, _ = ckpt.load_config(checkpoint)
    lang, speaker = ckpt.load_vocabs(checkpoint)
    system = build_system(cfg, lang.n_words, max(speaker.n_words, 1),
                          device=device)
    ckpt.load_state(checkpoint, system, optimizers=False)
    return cfg, lang, speaker, system


def cmd_eval(argv: list[str]) -> int:
    """Validation metrics of a checkpoint on a clip set (reference
    synthesize.py eval mode); prints them as a dict."""
    from ha2g_torch.checkpoint import load_config, load_state, load_vocabs
    from ha2g_torch.train.loop import Trainer

    p = argparse.ArgumentParser(prog="ha2g_torch.cli eval")
    p.add_argument("checkpoint")
    p.add_argument("--clips", default="synthetic")
    p.add_argument("--bc", action="store_true",
                   help="also compute beat consistency")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)

    cfg, _ = load_config(a.checkpoint)
    lang, speaker = load_vocabs(a.checkpoint)
    # only the given clips are read, not the checkpoint's training set
    cfg, lang, speaker, _, val_s = _prepare(
        cfg.replace(train_data_path=a.clips, test_data_path=a.clips), lang,
        speaker)
    trainer = Trainer(cfg, val_s, val_s, lang, speaker,
                      make_evaluator(cfg, device),
                      beat_consistency_score=a.bc, device=device)
    load_state(a.checkpoint, trainer.system, optimizers=False)
    metrics = trainer.evaluate(0)
    print({k: round(float(v), 5) for k, v in metrics.items()})
    return 0


def cmd_synthesize(argv: list[str]) -> int:
    """Synthesis from a checkpoint on the first ``--n`` clips of a clip set
    (reference synthesize_hierarchy.py from_db_clip); writes dir_vec and
    audio to ``--out``."""
    from ha2g_torch.synthesis import fade_out_to_mean, make_synthesizer

    p = argparse.ArgumentParser(prog="ha2g_torch.cli synthesize")
    p.add_argument("checkpoint")
    p.add_argument("--clips", default="synthetic")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--out", default="synthesis_out.npz")
    p.add_argument("--fused", action="store_true",
                   help="hierarchy: the audio encoder once over all windows")
    p.add_argument("--fade_out", action="store_true",
                   help="append the fade to the mean pose")
    p.add_argument("--render", action="store_true",
                   help="also render the first clip's skeleton animation")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)

    cfg, lang, speaker, system = load_checkpoint_system(a.checkpoint, device)
    clips = _load_split(a.clips, cfg, 2)[:a.n]
    synth = make_synthesizer(system, system.state_dict())
    n_samples = min(len(c["audio_raw"]) for c in clips)
    audio = np.stack([np.asarray(c["audio_raw"][:n_samples], np.float32)
                      for c in clips])
    words = [c["words"] for c in clips]
    vids = np.asarray([speaker.get_word_index(c["vid"]) for c in clips],
                      np.int64)
    if a.fused and hasattr(synth, "generate_fused"):
        out = synth.generate_fused(audio, words, lang, vids)
        if a.fade_out:
            out = np.stack([fade_out_to_mean(r, cfg, 0.0) for r in out])
    else:
        out = synth.generate(audio, words, lang, vids, fade_out=a.fade_out)
    np.savez(a.out, dir_vec=out, audio=audio)
    print(f"wrote {a.out}: {out.shape}")
    if a.render:
        from ha2g_torch.render import create_video_and_save
        path = create_video_and_save(
            str(Path(a.out).parent), 0, "synth", 0, None, out[0],
            cfg.mean_dir_vec_array, "synthesized", cfg.skeleton,
            audio=audio[0])
        print(f"rendered {path}")
    return 0


def read_wav(path) -> np.ndarray:
    """A 16 kHz mono 16-bit WAV file -> float32 samples (x / 32767, as
    the JAX command reads it)."""
    import wave
    with wave.open(str(path), "rb") as w:
        if (w.getframerate(), w.getnchannels(), w.getsampwidth()) != \
                (16000, 1, 2):
            raise ValueError(f"{path}: need 16 kHz mono 16-bit PCM, got "
                             f"{w.getframerate()} Hz, {w.getnchannels()} "
                             f"channels, {8 * w.getsampwidth()} bits")
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / 32767.0


def cmd_from_text(argv: list[str]) -> int:
    """Gestures for a transcript spoken in a WAV file (reference
    synthesize.py:273-338): the words spread evenly over the audio, one
    clip, speaker 0, faded out to the mean pose; writes dir_vec and audio
    to ``--out``."""
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.tts_align import uniform_align

    p = argparse.ArgumentParser(prog="ha2g_torch.cli from-text")
    p.add_argument("checkpoint")
    p.add_argument("--text", required=True)
    p.add_argument("--wav", required=True, help="16 kHz mono 16-bit WAV "
                   "(text-to-speech is not ported)")
    p.add_argument("--out", default="from_text_out.npz")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)

    cfg, lang, speaker, system = load_checkpoint_system(a.checkpoint, device)
    audio = read_wav(a.wav)[None]
    words = uniform_align(a.text, audio.shape[1] / 16000.0)
    synth = make_synthesizer(system, system.state_dict())
    out = synth.generate(audio, [words], lang, np.zeros(1, np.int64),
                         fade_out=True)
    np.savez(a.out, dir_vec=out, audio=audio)
    print(f"wrote {a.out}: {out.shape}")
    return 0


def cmd_serve(argv: list[str]) -> int:
    """The warm model behind the HTTP/JSON API of ``serve.py``."""
    from ha2g_torch.serve import serve_forever

    p = argparse.ArgumentParser(prog="ha2g_torch.cli serve")
    p.add_argument("checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8017)
    p.add_argument("--max_clip_seconds", type=float, default=20.0)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--batch_window_ms", type=float, default=30.0)
    p.add_argument("--no_low_latency", action="store_true",
                   help="accepted for the JAX command line; selects "
                        "nothing here")
    p.add_argument("--stream_batching", action="store_true",
                   help="batch ready windows of concurrent live streams")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    serve_forever(a.checkpoint, a.host, a.port,
                  max_clip_seconds=a.max_clip_seconds,
                  max_batch=a.max_batch, batch_window_ms=a.batch_window_ms,
                  low_latency=not a.no_low_latency,
                  stream_batching=a.stream_batching, device=_device(a.device))
    return 0


def cmd_import_checkpoint(argv: list[str]) -> int:
    """A reference ``.bin`` (hierarchy, or a baseline's generic
    checkpoint) -> a port checkpoint directory, with its config
    (``ref_routing_compat`` on for a TED Expressive hierarchy) and
    vocabularies, loaded strictly into a freshly built system."""
    from ha2g_torch import reference_ckpt as rc
    from ha2g_torch.checkpoint import save_checkpoint
    from ha2g_torch.train.loop import build_system

    p = argparse.ArgumentParser(prog="ha2g_torch.cli import-checkpoint")
    p.add_argument("bin_path")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)

    ckpt = rc.load_reference_checkpoint(a.bin_path)
    cfg = rc.config_from_reference_args(ckpt["args"])
    state = rc.import_checkpoint(ckpt, cfg)     # raises for an embedder
    lang = rc.vocab_from_pickled(ckpt["lang_model"])
    speaker = rc.vocab_from_pickled(ckpt["speaker_model"])
    system = build_system(cfg, lang.n_words, max(speaker.n_words, 1),
                          device=device)
    system.load_state_dict(state, strict=True)
    save_checkpoint(a.out_dir, system, cfg, lang, speaker,
                    extra={"epoch": int(ckpt.get("epoch", 0)),
                           "imported_from": str(a.bin_path)})
    print(f"imported {a.bin_path} -> {a.out_dir} "
          f"({len(system.state_dict())} tensors)")
    return 0


def cmd_export_checkpoint(argv: list[str]) -> int:
    """A checkpoint directory (port or JAX) or an FGD embedder directory ->
    the reference's ``.bin`` layout."""
    import torch
    from ha2g_torch import reference_ckpt as rc
    from ha2g_torch.checkpoint import load_config, load_embedder

    p = argparse.ArgumentParser(prog="ha2g_torch.cli export-checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("out_bin")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)

    cfg, extra = load_config(a.checkpoint)
    epoch = int(extra.get("epoch", 0))
    if cfg.model == "gesture_autoencoder":
        cfg, state = load_embedder(a.checkpoint)
        ckpt = rc.export_embedder_checkpoint(state, cfg, epoch)
        what = f"FGD embedder, pose_dim {cfg.pose_dim}"
    else:
        cfg, lang, speaker, system = load_checkpoint_system(a.checkpoint,
                                                            device)
        ckpt = rc.export_checkpoint(system.state_dict(), cfg, lang, speaker,
                                    epoch)
        what = f"hierarchy, {cfg.skeleton.n_levels} gen_dicts" \
            if cfg.model == "hierarchy" else f"{cfg.model}, generic layout"
    torch.save(ckpt, a.out_bin)
    print(f"wrote {a.out_bin} ({what})")
    return 0


def cmd_import_evalnet(argv: list[str]) -> int:
    """A reference FGD embedder ``.bin`` -> an embedder directory
    (``checkpoint.save_embedder``): EmbeddingNet from ``gen_dict`` for
    pose_dim 27, MotionAE from ``motion_ae`` for 126
    (embedding_space_evaluator.py:27-34)."""
    from ha2g_torch import reference_ckpt as rc
    from ha2g_torch.checkpoint import save_embedder
    from ha2g_torch.config import Config
    from ha2g_torch.eval.fgd import make_embedder

    p = argparse.ArgumentParser(prog="ha2g_torch.cli import-evalnet")
    p.add_argument("bin_path")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)

    pose_dim, latent_dim, state = rc.import_embedder_checkpoint(
        rc.load_reference_checkpoint(a.bin_path))
    net = make_embedder(pose_dim, 34, latent_dim).to(device)
    net.load_state_dict(state, strict=True)
    save_embedder(a.out_dir, net, Config(
        model="gesture_autoencoder",
        dataset="ted_expressive" if pose_dim == 126 else "ted_gesture",
        pose_dim=pose_dim, n_poses=34, latent_dim=latent_dim))
    print(f"imported eval net {a.bin_path} -> {a.out_dir}")
    return 0


def cmd_import_lmdb(argv: list[str]) -> int:
    """A reference lmdb -> clip storage (``--format source``, one {vid,
    clips} record a video) or windowed samples and vocabularies
    (``--format cache``, the reference's per-window ``lmdb_*_cache``).
    Host only."""
    from ha2g_torch.data.lmdb_import import import_cache_lmdb, import_lmdb

    p = argparse.ArgumentParser(prog="ha2g_torch.cli import-lmdb")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--format", choices=("source", "cache"), default="source")
    p.add_argument("--n_poses", type=int, default=34)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--max_words", type=int, default=32,
                   help="cache: the word sequence's cut, SOS and EOS "
                        "included")
    p.add_argument("--remove_word_timing", action="store_true",
                   help="cache: spread each window's words evenly over its "
                        "frames")
    a = p.parse_args(argv)
    if a.format == "cache":
        n = import_cache_lmdb(a.src, a.dst, n_poses=a.n_poses, fps=a.fps,
                              max_words=a.max_words,
                              remove_word_timing=a.remove_word_timing,
                              limit=a.limit)
        print(f"imported {n} windowed samples -> {a.dst}")
    else:
        if a.max_words != 32 or a.remove_word_timing:
            p.error("--max_words and --remove_word_timing apply to "
                    "--format cache")
        n = import_lmdb(a.src, a.dst, a.limit)
        print(f"imported {n} clips -> {a.dst}")
    return 0


def cmd_import_embeddings(argv: list[str]) -> int:
    """A fastText ``.bin`` or text ``.vec`` aligned to the vocabulary of a
    config's clips -> the (n_words, dim) ``.npy`` table that
    ``wordembed_path`` can name (reference vocab.py:70-84 does this at
    every training start).  Host only."""
    from ha2g_torch.config import parse_cli
    from ha2g_torch.data.vocab import build_vocab

    p = argparse.ArgumentParser(prog="ha2g_torch.cli import-embeddings")
    p.add_argument("model", help="fastText .bin or .vec/.txt text vectors")
    p.add_argument("out", help="output .npy path")
    p.add_argument("--config", required=True,
                   help="training config whose clips define the vocabulary")
    p.add_argument("--dim", type=int, default=300)
    a, rest = p.parse_known_args(argv)
    cfg = parse_cli(["--config", a.config] + rest)
    lang = build_vocab("words", [
        _load_split(cfg.train_data_path, cfg, 0),
        _load_split(cfg.test_data_path or cfg.val_data_path, cfg, 1)])
    lang.load_word_vectors(a.model, a.dim)
    np.save(a.out, lang.word_embedding_weights)
    print(f"aligned {lang.n_words} words x {a.dim} -> {a.out}")
    return 0


def _fmt_floats(arr, per_line=6, indent="  "):
    """A YAML flow sequence at the reference's 7 digits
    (calculate_motion_stats.py:57)."""
    vals = [f"{float(v):.7g}" for v in np.asarray(arr).reshape(-1)]
    lines = [", ".join(vals[i:i + per_line])
             for i in range(0, len(vals), per_line)]
    return "[\n" + indent + (",\n" + indent).join(lines) + "]"


def cmd_motion_stats(argv: list[str]) -> int:
    """mean_pose / mean_dir_vec / mean bone lengths of a clip store as a
    block for a YAML config (calculate_motion_stats.py:12-51).  Host
    only."""
    from ha2g_torch.config import Config
    from ha2g_torch.data.storage import load_clips
    from ha2g_torch.tools import motion_stats

    p = argparse.ArgumentParser(prog="ha2g_torch.cli motion-stats")
    p.add_argument("clips", help="clip-storage directory (a train split)")
    p.add_argument("--dataset", default="ted_expressive",
                   choices=("ted_gesture", "ted_expressive"))
    p.add_argument("--fps", type=int, default=15)
    a = p.parse_args(argv)

    spec = Config(model="hierarchy", dataset=a.dataset).skeleton
    clips = load_clips(a.clips)
    stats = motion_stats(clips, spec, fps=a.fps)
    total_s = sum(c["end_time"] - c["start_time"] for c in clips)
    print(f"# {len(clips)} clips, {stats['n_frames']} frames, "
          f"{total_s / 3600.0:.1f} h of valid clips")
    print("mean_pose:", _fmt_floats(stats["mean_pose"]))
    print("mean_dir_vec:", _fmt_floats(stats["mean_dir_vec"]))
    print("# mean bone lengths (skeleton.py bone table):",
          [round(float(v), 4) for v in stats["mean_bone_lengths"]])
    return 0


def cmd_angle_stats(argv: list[str]) -> int:
    """Each angle pair's mean / variance / mean frame-to-frame change over
    a config's windowed training targets, the physical prior's constants
    (calculate_angle_stats.py:39-197).  Host only."""
    from ha2g_torch.config import parse_cli
    from ha2g_torch.tools import angle_stats

    p = argparse.ArgumentParser(prog="ha2g_torch.cli angle-stats")
    p.add_argument("--config", required=True,
                   help="training config (data paths, windowing, "
                        "mean_dir_vec)")
    a, rest = p.parse_known_args(argv)
    cfg, _, _, train_s, _ = _prepare(parse_cli(["--config", a.config]
                                               + rest))
    stats = angle_stats(np.asarray(train_s.target), cfg.mean_dir_vec_array,
                        cfg.skeleton)
    pairs = cfg.skeleton.angle_prior.pairs
    print(f"# {len(train_s)} windows x {cfg.n_poses} frames, "
          f"{len(pairs)} angle pairs")
    print("angle_pairs:", [list(q) for q in pairs])
    print("avg_angle:", _fmt_floats(stats["avg_angle"]))
    print("var_angle:", _fmt_floats(stats["var_angle"]))
    print("change_angle:", _fmt_floats(stats["change_angle"]))
    return 0


def cmd_parse_reference_log(argv: list[str]) -> int:
    """A reference training log -> a baseline JSON for
    ``compare-trajectory`` (eval/trajectory.py).  Host only."""
    import json
    from ha2g_torch.eval.trajectory import parse_reference_log

    p = argparse.ArgumentParser(prog="ha2g_torch.cli parse-reference-log")
    p.add_argument("log_path")
    p.add_argument("--out", default=None, help="output JSON (default: "
                   "ha2g_torch/baselines/<log stem>.json)")
    a = p.parse_args(argv)
    traj = parse_reference_log(a.log_path)
    out = Path(a.out) if a.out else (
        Path(__file__).resolve().parent / "baselines" / f"{traj.name}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(traj.to_json(), indent=1))
    print(f"parsed {len(traj.val)} val epochs, {len(traj.train)} train lines"
          f" -> {out}")
    print("best:", dict(traj.best))
    return 0


def cmd_compare_trajectory(argv: list[str]) -> int:
    """A run's history.jsonl against a reference trajectory (a baseline's
    name or a log's path): a verdict a metric; exit 1 when one is BEHIND
    or INSUFFICIENT_REF.  Host only."""
    import json
    from ha2g_torch.eval import trajectory as tj

    p = argparse.ArgumentParser(prog="ha2g_torch.cli compare-trajectory")
    p.add_argument("history", help="history.jsonl of a Trainer run")
    p.add_argument("--ref", default="ted_gesture_new",
                   help="baseline name or reference log path")
    p.add_argument("--keys",
                   default="frechet,joint_mae,diversity,feat_dist,loss")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the report as JSON")
    a = p.parse_args(argv)
    ref = (tj.parse_reference_log(a.ref) if Path(a.ref).exists()
           else tj.load_baseline(a.ref))
    report = tj.compare_trajectories(ref, tj.load_history_jsonl(a.history),
                                     keys=tuple(a.keys.split(",")))
    print(tj.format_report(report))
    if a.json_out:
        Path(a.json_out).write_text(json.dumps(report, indent=1))
    bad = [k for k, e in report["metrics"].items()
           if e["verdict"] in ("BEHIND", "INSUFFICIENT_REF")]
    return 1 if bad else 0


DOCTOR_MEL_DB = 1e-2     # the JAX doctor's bound on the mel front-end
# the doctor's tiny hierarchy (3 levels at pose 27, one GRU layer of 16)
# and its batch
DOCTOR_CONFIG = dict(model="hierarchy", pose_dim=27, hidden_size=16,
                     n_layers=1)
DOCTOR_BATCH = 2


def cmd_doctor(argv: list[str]) -> int:
    """Self-check of an install on its device: the device and its power
    limit, the mel front-end on the device against the numpy oracle, and
    a tiny hierarchy GAN step (pose 27, hidden 16, one GRU layer, batch 2)
    whose kernels (B1, its backward, B2-B4) must launch on a card.  Exit 0
    only if all of it holds."""
    import subprocess
    import time

    import torch

    from ha2g_torch.config import Config
    from ha2g_torch.data.synthetic import default_mean_dir_vec
    from ha2g_torch.ops import contrastive, gru_kernel
    from ha2g_torch.ops.mel import batched_log_mel, log_mel_np
    from ha2g_torch.skeleton import TED_GESTURE
    from ha2g_torch.train.hierarchy import HierarchySystem

    p = argparse.ArgumentParser(prog="ha2g_torch.cli doctor")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = _device(a.device)
    ok = True
    if device.type == "cuda":
        try:        # the card's name and power limit
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        except (OSError, subprocess.CalledProcessError, IndexError) as err:
            smi, ok = f"FAIL: {err}", False
        print(f"device: {torch.cuda.get_device_name(device)} "
              f"(count {torch.cuda.device_count()}; nvidia-smi: {smi})")
    else:
        print("device: cpu (the kernels' plain versions)")

    rng = np.random.default_rng(0)
    y = (rng.normal(size=16000) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    mel = batched_log_mel(torch.from_numpy(y)[None].to(device))[0].cpu()
    err = float(np.abs(mel.numpy() - log_mel_np(y)).max())
    print(f"mel front-end: {tuple(mel.shape)}, max |device - numpy oracle| "
          f"= {err:.2e} dB ({time.perf_counter() - t0:.1f}s)")
    ok = ok and err < DOCTOR_MEL_DB

    cfg = Config(**DOCTOR_CONFIG, mean_dir_vec=[
        float(v) for v in default_mean_dir_vec(TED_GESTURE)])
    t0 = time.perf_counter()
    system = HierarchySystem(cfg, n_words=8, n_speakers=2, device=device,
                             generator=torch.Generator().manual_seed(0))
    B = DOCTOR_BATCH
    batch = {"text": rng.integers(0, 8, (B, cfg.n_poses)),
             "spec": rng.normal(size=(B, 128, 70)).astype(np.float32),
             "target": (rng.normal(size=(B, cfg.n_poses, 27)) * 0.2)
             .astype(np.float32),
             "vids": np.arange(B) % 2}
    counters = {"b1": gru_kernel.gru_recurrence,
                "b1_bwd": gru_kernel.gru_backward_loop,
                "b2": contrastive.contrastive_fwd,
                "b3": contrastive.contrastive_bwd_da,
                "b4": contrastive.contrastive_bwd_db}
    before = {k: fn.launches for k, fn in counters.items()}
    metrics = system.train_step(batch, True, torch.Generator(
        device=device).manual_seed(1))
    loss = float(metrics["loss"])
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    print(f"tiny hierarchy GAN step: loss {loss:.3f}, kernel launches "
          f"{launches} ({time.perf_counter() - t0:.1f}s)")
    ok = ok and np.isfinite(loss)
    if device.type == "cuda":
        ok = ok and all(launches.values())
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


def cmd_build_dataset(argv: list[str]) -> int:
    """The dataset construction: download -> audio -> pose -> scenes ->
    word timings -> filter -> clip-storage splits (the reference's
    scripts run by hand, dataset_script/README.md:37-88, chained with
    resume from each step's artifact); prints the result dict."""
    from ha2g_torch.dataset_pipeline.pipeline import build_dataset

    p = argparse.ArgumentParser(prog="ha2g_torch.cli build-dataset")
    p.add_argument("ids", nargs="*", help="YouTube video ids")
    p.add_argument("--video-ids", default=None,
                   help="a file of video ids, one a line (reference "
                        "video_ids.txt)")
    p.add_argument("--work", required=True, help="working directory "
                   "(videos/, audio/, keypoints/, scenes/, align/)")
    p.add_argument("--out", required=True, help="clip-storage output dir")
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--min-shoulder-px", type=float, default=100.0)
    p.add_argument("--qa-report", action="store_true",
                   help="write <out>/qa_report.html (the headless "
                        "review_filtered_clips)")
    a = p.parse_args(argv)

    ids = list(a.ids)
    if a.video_ids:
        ids += [ln.strip() for ln in Path(a.video_ids).read_text().split()
                if ln.strip() and not ln.startswith("#")]
    if not ids:
        print("no video ids given")
        return 1
    logging.basicConfig(level=logging.INFO)
    result = build_dataset(ids, a.work, a.out, fps=a.fps,
                           min_shoulder_px=a.min_shoulder_px,
                           qa_report=a.qa_report)
    print(result)
    return 0 if result["videos"] else 1


def cmd_make_librosa_goldens(argv: list[str]) -> int:
    """The DSP golden fixture computed by librosa itself (needs librosa
    0.8; the JAX package's tests/test_mel_oracles.py reads it)."""
    from ha2g_torch.tools import make_librosa_goldens

    p = argparse.ArgumentParser(prog="ha2g_torch.cli make-librosa-goldens")
    p.add_argument("out", nargs="?",
                   default="tests/fixtures/librosa_goldens.npz")
    a = p.parse_args(argv)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    print(f"wrote {make_librosa_goldens(a.out)}")
    return 0


COMMANDS = {"train": cmd_train, "eval": cmd_eval,
            "synthesize": cmd_synthesize, "from-text": cmd_from_text,
            "serve": cmd_serve, "import-checkpoint": cmd_import_checkpoint,
            "export-checkpoint": cmd_export_checkpoint,
            "import-evalnet": cmd_import_evalnet,
            "import-lmdb": cmd_import_lmdb,
            "import-embeddings": cmd_import_embeddings,
            "motion-stats": cmd_motion_stats,
            "angle-stats": cmd_angle_stats,
            "parse-reference-log": cmd_parse_reference_log,
            "compare-trajectory": cmd_compare_trajectory,
            "doctor": cmd_doctor, "build-dataset": cmd_build_dataset,
            "make-librosa-goldens": cmd_make_librosa_goldens}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m ha2g_torch.cli {{{'|'.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
