"""Importers from the reference's lmdb datasets (the port of
ha2g_tpu/data/lmdb_import.py).

The released TED Gesture / TED Expressive datasets are lmdb stores of
pyarrow-0.14 legacy-serialized records (reference
lmdb_data_loader.py:108-115, data_preprocessor.py:41-56).  They are read
here with the port's own lmdb reader (``lmdb_mini``) and codec
(``arrow_legacy``), never with an installed `lmdb` or `pyarrow`:

* ``import_lmdb``: a *source* lmdb (one {vid, clips} record a video) into
  the clip storage of ``storage.py``;
* ``import_cache_lmdb``: a preprocessed *cache* lmdb (one record a
  window, the reference training code's ``lmdb_*_cache``) into fixed-shape
  ``WindowedSamples`` and the two vocabularies, ``load_imported_samples``
  reading them back;
* ``write_reference_lmdb``: a source lmdb in the reference's bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ha2g_torch.data.arrow_legacy import deserialize, serialize
from ha2g_torch.data.dataset import (WindowedSamples, frame_word_indices,
                                     spectrogram_length_for)
from ha2g_torch.data.lmdb_mini import MiniLmdbReader, write_lmdb
from ha2g_torch.data.storage import save_clips
from ha2g_torch.data.vocab import EOS_TOKEN, SOS_TOKEN, Vocab

SAMPLE_KEYS = ("text", "word_seq", "word_lengths", "pose", "target", "audio",
               "spec", "vids")


def _records(lmdb_dir, limit=None):
    """The decoded values of an lmdb environment, in key order (at most
    ``limit`` of them)."""
    if not Path(lmdb_dir).exists():
        raise FileNotFoundError(lmdb_dir)
    reader = MiniLmdbReader(lmdb_dir)
    try:
        for n, (_key, value) in enumerate(reader.items(), 1):
            record = deserialize(value)
            del value            # the reader's map closes with no view left
            yield record
            if limit and n >= limit:
                return
    finally:
        reader.close()


def import_lmdb(lmdb_dir, out_dir, limit=None) -> int:
    """A source lmdb -> clip storage at ``out_dir``; -> the clips written
    (at most ``limit``)."""
    clips = []
    for video in _records(lmdb_dir):
        for clip in video["clips"]:
            clips.append({
                "vid": video["vid"],
                "skeletons_3d": clip["skeletons_3d"],
                "audio_raw": clip["audio_raw"],
                "audio_spec": clip.get("audio_feat"),
                "words": [tuple(w) for w in clip["words"]],
                "start_time": float(clip["start_time"]),
                "end_time": float(clip["end_time"]),
                "start_frame_no": int(clip["start_frame_no"]),
                "end_frame_no": int(clip["end_frame_no"]),
            })
            if limit and len(clips) >= limit:
                break
        if limit and len(clips) >= limit:
            break
    save_clips(out_dir, clips)
    return len(clips)


def write_reference_lmdb(lmdb_dir, videos: list[dict]):
    """A source lmdb in the reference's format (keys ``'{:010}'.format(i)``,
    values the legacy-serialized {vid, clips} records, as
    make_ted_dataset.py:215-220 writes them); -> the data file."""
    return write_lmdb(lmdb_dir, {
        f"{i:010}".encode("ascii"): serialize(v)
        for i, v in enumerate(videos)})


def import_cache_lmdb(lmdb_dir, out_dir, n_poses: int = 34, fps: int = 15,
                      max_words: int = 32, remove_word_timing: bool = False,
                      limit=None) -> int:
    """A cache lmdb -> ``<out_dir>/{samples.npz, vocab.json,
    speaker.json}``; -> the samples written.

    A record is [words, poses, normalized_dir_vec, audio, spectrogram,
    aux_info] with aux_info {vid, start_frame_no, end_frame_no,
    start_time, end_time} (data_preprocessor.py:150-165); the direction
    vectors are already mean-subtracted.  The ``__getitem__`` clipping and
    both word encodings (lmdb_data_loader.py:116-166) happen here."""
    records = list(_records(lmdb_dir, limit))

    lang = Vocab("words")
    speaker = Vocab("vid", insert_default_tokens=False)
    for words, *_rest, aux in records:
        for w in words:
            lang.index_word(w[0])
        speaker.index_word(aux["vid"])

    audio_len = int(round(n_poses / fps * 16000))
    spec_len = spectrogram_length_for(n_poses, fps)
    rows = {k: [] for k in ("text", "word_seq", "pose", "target", "audio",
                            "spec", "vids")}
    for words, poses, vec_seq, audio, spectrogram, aux in records:
        poses = np.asarray(poses, np.float32)
        vec_seq = np.asarray(vec_seq, np.float32)
        audio = np.asarray(audio, np.float32)
        spectrogram = np.asarray(spectrogram, np.float32)
        start = float(aux["start_time"])
        duration = float(aux["end_time"]) - start
        # do_clipping (lmdb_data_loader.py:154-162)
        sample_end_time = start + duration * n_poses / vec_seq.shape[0]
        if len(audio) < audio_len:
            audio = np.pad(audio, (0, audio_len - len(audio)),
                           mode="symmetric")
        audio = audio[:audio_len]
        spectrogram = spectrogram[:, :spec_len]
        vec_seq = vec_seq[:n_poses]
        poses = poses[:n_poses]

        ext = frame_word_indices(words, start,
                                 (sample_end_time - start) / n_poses,
                                 n_poses, lang, remove_word_timing)
        seq = [SOS_TOKEN]
        for w in words:
            if w[1] > sample_end_time:
                break
            seq.append(lang.get_word_index(w[0]))
        # a long window is cut, its EOS kept (seq2seq and the joint
        # embedding read up to a trailing EOS)
        seq = seq[:max_words - 1] + [EOS_TOKEN]

        rows["text"].append(ext)
        rows["word_seq"].append(np.asarray(seq, np.int32))
        rows["pose"].append(poses.reshape(n_poses, -1))
        rows["target"].append(vec_seq.reshape(n_poses, -1))
        rows["audio"].append(audio)
        rows["spec"].append(spectrogram)
        rows["vids"].append(speaker.get_word_index(aux["vid"]))

    n = len(rows["text"])
    if n == 0:
        raise ValueError(f"no samples in {lmdb_dir}")
    lengths = np.asarray([len(s) for s in rows["word_seq"]], np.int32)
    word_seq = np.zeros((n, max(int(lengths.max()), 2)), np.int32)
    for i, s in enumerate(rows["word_seq"]):
        word_seq[i, :len(s)] = s
    samples = WindowedSamples(
        text=np.stack(rows["text"]), word_seq=word_seq,
        word_lengths=lengths, pose=np.stack(rows["pose"]),
        target=np.stack(rows["target"]), audio=np.stack(rows["audio"]),
        spec=np.stack(rows["spec"]),
        vids=np.asarray(rows["vids"], np.int32))

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / "samples.npz",
                        **{k: getattr(samples, k) for k in SAMPLE_KEYS})
    lang.save(out / "vocab.json")
    speaker.save(out / "speaker.json")
    return n


def load_imported_samples(path):
    """An ``import_cache_lmdb`` directory -> (WindowedSamples, word Vocab,
    speaker Vocab)."""
    path = Path(path)
    with np.load(path / "samples.npz") as z:
        samples = WindowedSamples(**{k: z[k] for k in z.files})
    return (samples, Vocab.load(path / "vocab.json"),
            Vocab.load(path / "speaker.json"))


def has_imported_samples(path) -> bool:
    return bool(path) and (Path(path) / "samples.npz").is_file()
