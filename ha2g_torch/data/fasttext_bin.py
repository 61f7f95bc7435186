"""A pure-Python fastText model reader and writer (the port of
ha2g_tpu/data/fasttext_bin.py).

The reference reads pretrained word vectors from the released
``crawl-300d-2M-subword.bin`` with the `fasttext` package
(scripts/model/vocab.py:70-84: ``fasttext.load_model`` and
``get_word_vector`` a vocabulary word).  The port never imports that
package; this module reads the binary model format and computes the
subword word vectors itself:

* file layout (fastText C++ ``FastText::loadModel``):
  ``magic:int32=793712314, version:int32,
  args{dim ws epoch minCount neg wordNgrams loss model bucket minn maxn
  lrUpdateRate:int32 x12, t:double},
  dict{size nwords nlabels:int32 x3, ntokens pruneidx_size:int64 x2,
  size x (cstring word, count:int64, type:int8), pruneidx pairs:int32 x2},
  quant_input:int8, input{m n:int64 x2, data:float32[m*n]},
  quant_output:int8, output{m n:int64 x2, data:float32[m*n]}``
* ``get_word_vector(w)`` = the mean of the input rows of the word's
  subwords: its own row (in the vocabulary) and the hashed character
  n-grams of ``<w>``, minn..maxn UTF-8 code points long
  (``Dictionary::initNgrams`` / ``computeSubwords``), FNV-1a hashed with
  fastText's signed-char quirk (``Dictionary::hash``).

The input matrix is memory-mapped, so the 4.8 GB crawl model loads
lazily.  ``write_model`` writes the same layout (fixtures, small custom
models); quantized (.ftz) models are not supported.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

FASTTEXT_MAGIC = 793712314
FASTTEXT_VERSION = 12
_BOW, _EOW, _EOS = b"<", b">", b"</s>"
_ARG_FIELDS = ("dim", "ws", "epoch", "min_count", "neg", "word_ngrams",
               "loss", "model", "bucket", "minn", "maxn", "lr_update_rate")


def ft_hash(data: bytes) -> int:
    """fastText's FNV-1a (Dictionary::hash) including the signed-char
    cast: bytes >= 0x80 are sign-extended before the xor."""
    h = 2166136261
    for b in data:
        if b >= 0x80:
            b |= 0xFFFFFF00  # int8 -> uint32 sign extension
        h = (h ^ b) & 0xFFFFFFFF
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def compute_subword_hashes(word: bytes, minn: int, maxn: int) -> list[int]:
    """Bucket hashes of char n-grams of `word` (already BOW/EOW-wrapped),
    UTF-8 codepoint-aware (Dictionary::computeSubwords).  Returns raw
    ``hash % bucket`` values; callers add ``nwords``."""
    out: list[int] = []
    n_bytes = len(word)
    for i in range(n_bytes):
        if (word[i] & 0xC0) == 0x80:  # UTF-8 continuation byte
            continue
        j, n = i, 1
        ngram = bytearray()
        while j < n_bytes and n <= maxn:
            ngram.append(word[j])
            j += 1
            while j < n_bytes and (word[j] & 0xC0) == 0x80:
                ngram.append(word[j])
                j += 1
            if n >= minn and not (n == 1 and (i == 0 or j == n_bytes)):
                out.append(ft_hash(bytes(ngram)))
            n += 1
    return out


class FastTextModel:
    """A loaded (non-quantized) fastText model: vocabulary + input matrix
    + subword inference.  Mirrors the `fasttext` package surface used by
    the reference (get_word_vector / words / get_dimension)."""

    def __init__(self, args: dict, words: list[str], counts: list[int],
                 input_matrix: np.ndarray, pruneidx: dict[int, int] | None,
                 nwords: int):
        self.args = args
        self.dim = args["dim"]
        self.bucket = args["bucket"]
        self.minn, self.maxn = args["minn"], args["maxn"]
        self.words = words
        self.word2id = {w: i for i, w in enumerate(words)}
        self.counts = counts
        self.input = input_matrix  # (nwords + bucket, dim), possibly memmap
        self.pruneidx = pruneidx
        self.nwords = nwords

    def get_dimension(self) -> int:
        return self.dim

    def _push_hash(self, ids: list[int], h: int):
        # Dictionary::pushHash: pruned models remap bucket ids
        if self.pruneidx is not None:
            if h in self.pruneidx:
                h = self.pruneidx[h]
            else:
                return
        ids.append(self.nwords + h)

    def subword_ids(self, word: str) -> list[int]:
        """Input-matrix row ids for `word` (Dictionary::getSubwords)."""
        wid = self.word2id.get(word)
        ids: list[int] = []
        if wid is not None:
            ids.append(wid)
        if word == _EOS.decode():
            return ids
        if self.maxn <= 0 and wid is not None:
            return ids
        wrapped = _BOW + word.encode("utf-8") + _EOW
        for h in compute_subword_hashes(wrapped, self.minn, self.maxn):
            self._push_hash(ids, h % self.bucket)
        return ids

    def get_word_vector(self, word: str) -> np.ndarray:
        """Mean of input rows over subwords (FastText::getWordVector)."""
        ids = self.subword_ids(word)
        if not ids:
            return np.zeros(self.dim, np.float32)
        return np.asarray(self.input[np.asarray(ids, np.int64)],
                          np.float32).mean(axis=0)


def load_model(path: str | Path) -> FastTextModel:
    """Read a .bin fastText model; the input matrix is memory-mapped."""
    path = Path(path)
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != FASTTEXT_MAGIC:
            raise ValueError(
                f"{path}: not a fastText model (magic {magic}); pre-0.9 "
                "models without the magic header are not supported")
        if version > FASTTEXT_VERSION:
            raise ValueError(f"unsupported fastText version {version}")
        args = dict(zip(_ARG_FIELDS, struct.unpack("<12i", f.read(48))))
        args["t"] = struct.unpack("<d", f.read(8))[0]
        size, nwords, nlabels = struct.unpack("<iii", f.read(12))
        _ntokens, pruneidx_size = struct.unpack("<qq", f.read(16))
        words, counts = [], []
        # entries: cstring + int64 count + int8 type.  Read in large
        # chunks and split on NULs — per-byte reads make the crawl
        # model's 2M-entry dictionary take tens of seconds
        buf = b""
        pos = 0
        CHUNK = 1 << 20
        for _ in range(size):
            nul = buf.find(b"\x00", pos)
            while nul < 0 or len(buf) - nul - 1 < 9:
                more = f.read(CHUNK)
                if not more:
                    raise ValueError("truncated fastText dictionary")
                buf = buf[pos:] + more
                pos = 0
                nul = buf.find(b"\x00", pos)
            words.append(buf[pos:nul].decode("utf-8", errors="replace"))
            count, _etype = struct.unpack_from("<qb", buf, nul + 1)
            counts.append(count)
            pos = nul + 10
        f.seek(pos - len(buf), 1)  # rewind unconsumed chunk bytes
        pruneidx = None
        if pruneidx_size >= 0:
            pruneidx = {}
            for _ in range(pruneidx_size):
                k, v = struct.unpack("<ii", f.read(8))
                pruneidx[k] = v
        quant_input = struct.unpack("<b", f.read(1))[0]
        if quant_input:
            raise ValueError("quantized (.ftz) models are not supported")
        m, n = struct.unpack("<qq", f.read(16))
        offset = f.tell()
    matrix = np.memmap(path, dtype="<f4", mode="r", offset=offset,
                       shape=(m, n))
    if nlabels:
        raise ValueError("supervised fastText models carry labels, not "
                         "word vectors")
    return FastTextModel(args, words, counts, matrix, pruneidx, nwords)


def write_model(path: str | Path, words: list[str],
                input_matrix: np.ndarray, bucket: int,
                minn: int = 5, maxn: int = 5,
                counts: list[int] | None = None):
    """Write a (non-quantized) model in the fastText binary layout.

    `input_matrix` must be (len(words) + bucket, dim).  Used to build
    byte-faithful test fixtures and small custom embedding models."""
    nwords = len(words)
    dim = input_matrix.shape[1]
    assert input_matrix.shape[0] == nwords + bucket
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", FASTTEXT_MAGIC, FASTTEXT_VERSION))
        args = dict(dim=dim, ws=5, epoch=5, min_count=1, neg=5,
                    word_ngrams=1, loss=2, model=2, bucket=bucket,
                    minn=minn, maxn=maxn, lr_update_rate=100)
        f.write(struct.pack("<12i", *[args[k] for k in _ARG_FIELDS]))
        f.write(struct.pack("<d", 1e-4))
        f.write(struct.pack("<iii", nwords, nwords, 0))       # size/nwords/nlabels
        f.write(struct.pack("<qq", sum(counts or [1] * nwords), -1))
        for i, w in enumerate(words):
            f.write(w.encode("utf-8") + b"\x00")
            f.write(struct.pack("<qb", (counts or [1] * nwords)[i], 0))
        f.write(struct.pack("<b", 0))                          # quant_input
        f.write(struct.pack("<qq", *input_matrix.shape))
        f.write(np.ascontiguousarray(input_matrix, "<f4").tobytes())
        f.write(struct.pack("<b", 0))                          # quant_output
        out = np.zeros((1, dim), "<f4")                        # unused head
        f.write(struct.pack("<qq", *out.shape))
        f.write(out.tobytes())


def load_vec_text(path: str | Path):
    """Parse the .vec text format (``n dim`` header, then ``word v0 v1
    ...`` rows) into (dict word->vector, dim)."""
    vectors: dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        header = f.readline().split()
        dim = int(header[1]) if len(header) == 2 else None
        if dim is None:  # headerless GloVe-style file: first row is data
            f.seek(0)
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            if dim is None:
                dim = len(parts) - 1
            vectors[parts[0]] = np.asarray(parts[-dim:], np.float32)
    return vectors, dim
