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

Data paths in a config are a clip-storage directory (data/storage.py) or
"synthetic" / "none" / empty, a built-in synthetic set; any other path
that does not exist raises, as does a named ``wordembed_path``.
``eval_net_path`` names an FGD embedder: a directory saved by
``checkpoint.save_embedder`` or ``import-evalnet``, or the
``checkpoint_best`` of a gesture_autoencoder run (the port's or the JAX
package's); without one the trainer selects checkpoints by the
validation loss.  Every command runs on CUDA unless ``--device cpu``
is given; without CUDA and without it, the commands raise.
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


def _prepare(cfg, lang=None, speaker=None):
    """Load the train and eval clips, build the vocabularies (or take the
    given ones, a checkpoint's), window the clips into samples.
    -> (cfg, lang, speaker, train samples, val samples)."""
    from ha2g_torch.data.dataset import window_clips
    from ha2g_torch.data.synthetic import default_mean_dir_vec
    from ha2g_torch.data.vocab import Vocab, build_vocab

    train_clips = _load_split(cfg.train_data_path, cfg, 0)
    # the reference validates on the test split (train.py:652-724)
    val_clips = _load_split(cfg.test_data_path or cfg.val_data_path, cfg, 1)
    if lang is None:
        lang = build_vocab("words", [train_clips, val_clips])
        if cfg.wordembed_path:     # a missing file raises
            lang.load_word_vectors(cfg.wordembed_path, cfg.wordembed_dim)
        else:
            lang.random_word_vectors(cfg.wordembed_dim)
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


COMMANDS = {"train": cmd_train, "eval": cmd_eval,
            "synthesize": cmd_synthesize, "from-text": cmd_from_text,
            "serve": cmd_serve, "import-checkpoint": cmd_import_checkpoint,
            "export-checkpoint": cmd_export_checkpoint,
            "import-evalnet": cmd_import_evalnet}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m ha2g_torch.cli {{{'|'.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
