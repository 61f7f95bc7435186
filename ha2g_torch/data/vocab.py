"""Word and speaker vocabularies (the port of ha2g_tpu/data/vocab.py,
reference scripts/model/vocab.py and scripts/utils/vocab_utils.py).

A ``Vocab`` maps words to indices with the PAD/SOS/EOS/UNK specials, or
without them as the speaker table, and may carry an embedding table.  It
is saved as JSON in the JAX package's schema, so the two packages read each
other's vocabulary files; the table goes beside it as ``.npy``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

import numpy as np

from ha2g_torch.data.fasttext_bin import load_model, load_vec_text

PAD_TOKEN = 0
SOS_TOKEN = 1
EOS_TOKEN = 2
UNK_TOKEN = 3


def normalize_string(s: str) -> str:
    """Lower-case, trim, and drop non-letter characters
    (reference data_utils.py:18-25)."""
    s = s.lower().strip()
    s = re.sub(r"([,.!?])", r" \1 ", s)
    s = re.sub(r"(['])", r"", s)
    s = re.sub(r"[^a-zA-Z,.!?]+", r" ", s)
    return re.sub(r"\s+", r" ", s).strip()


def remove_tags_marks(text: str) -> str:
    """Drop <...> tags and the marks . , : ; ! ? (the JAX package's
    data/vocab.py:36)."""
    return re.sub(r"<.*?>|[.,:;!?]+", "", text)


class Vocab:
    """Word <-> index mapping; unknown words map to UNK."""

    def __init__(self, name: str, insert_default_tokens: bool = True):
        self.name = name
        self.insert_default_tokens = insert_default_tokens
        self.word_embedding_weights: Optional[np.ndarray] = None
        self.reset_dictionary()

    def reset_dictionary(self):
        self.word2index: dict[str, int] = {}
        self.word2count: dict[str, int] = {}
        if self.insert_default_tokens:
            self.index2word = {PAD_TOKEN: "<PAD>", SOS_TOKEN: "<SOS>",
                               EOS_TOKEN: "<EOS>", UNK_TOKEN: "<UNK>"}
        else:
            self.index2word = {UNK_TOKEN: "<UNK>"}
        self.n_words = len(self.index2word)

    def index_word(self, word: str):
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def index_words_from_list(self, words):
        for w in words:
            self.index_word(w)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, UNK_TOKEN)

    # ---- embedding table ---------------------------------------------------
    def load_word_vectors_npy(self, path, embed_dim: int = 300):
        """A (n_words, embed_dim) table aligned to this vocabulary."""
        weights = np.load(path).astype(np.float32)
        if weights.shape != (self.n_words, embed_dim):
            raise ValueError(f"{path} holds a {weights.shape} table; the "
                             f"vocabulary needs ({self.n_words}, {embed_dim})")
        self.word_embedding_weights = weights

    def load_word_vectors(self, path, embed_dim: int = 300, seed: int = 0):
        """Pretrained vectors with the reference's semantics
        (vocab.py:70-84): the whole table drawn N(0, 1/sqrt(dim)) from
        ``default_rng(seed)``, then each vocabulary word's model vector
        written over its row.  By extension: ``.bin`` a fastText model
        (subword n-grams, so a word outside the model's vocabulary gets a
        vector too, as ``fasttext``'s get_word_vector gives it), ``.vec``
        / ``.txt`` text vectors (a word they lack keeps its random row),
        ``.npy`` a table aligned to this vocabulary.  A missing file
        raises."""
        path = Path(path)
        if path.suffix == ".npy":
            return self.load_word_vectors_npy(path, embed_dim)
        if not path.is_file():
            raise FileNotFoundError(f"no word vectors at {path}")
        rng = np.random.default_rng(seed)
        weights = rng.normal(0, 1 / np.sqrt(embed_dim),
                             (self.n_words, embed_dim)).astype(np.float32)
        if path.suffix == ".bin":
            model = load_model(path)
            if model.get_dimension() != embed_dim:
                raise ValueError(f"{path} has dim {model.get_dimension()}, "
                                 f"not {embed_dim}")
            for word, idx in self.word2index.items():
                weights[idx] = model.get_word_vector(word)
        else:
            vectors, dim = load_vec_text(path)
            if dim != embed_dim:
                raise ValueError(f"{path} has dim {dim}, not {embed_dim}")
            for word, idx in self.word2index.items():
                if word in vectors:
                    weights[idx] = vectors[word]
        self.word_embedding_weights = weights

    def random_word_vectors(self, embed_dim: int = 300, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.word_embedding_weights = rng.normal(
            size=(self.n_words, embed_dim)).astype(np.float32)

    # ---- serialisation -----------------------------------------------------
    def to_dict(self) -> dict:
        return {"name": self.name,
                "insert_default_tokens": self.insert_default_tokens,
                "n_words": self.n_words,
                "index2word": {str(k): v for k, v in self.index2word.items()},
                "word2count": self.word2count}

    @classmethod
    def from_dict(cls, d: dict) -> "Vocab":
        v = cls(d["name"], d["insert_default_tokens"])
        counts = d.get("word2count", {})
        for idx, word in sorted((int(k), w) for k, w in d["index2word"].items()):
            if v.index2word.get(idx) == word and word not in counts:
                continue  # a special placed by reset_dictionary
            v.word2index[word] = idx
            v.index2word[idx] = word
            v.word2count[word] = int(counts.get(word, 1))
            v.n_words = max(v.n_words, idx + 1)
        # without the specials, <UNK> sits at index 3 while words start at
        # 1 (the reference's layout), so the recorded count is restored
        if "n_words" in d:
            v.n_words = int(d["n_words"])
        return v

    def save(self, path):
        Path(path).write_text(json.dumps(self.to_dict()))

    @classmethod
    def load(cls, path) -> "Vocab":
        return cls.from_dict(json.loads(Path(path).read_text()))


def build_vocab(name: str, clip_sets, insert_default_tokens: bool = True
                ) -> Vocab:
    """Every word of every clip, in clip order (vocab_utils.py:11-35)."""
    vocab = Vocab(name, insert_default_tokens)
    for clips in clip_sets:
        for clip in clips:
            for word, _, _ in clip["words"]:
                vocab.index_word(word)
    return vocab
