"""The port's fastText reader (``fasttext_bin``, no `fasttext` package)
and ``Vocab.load_word_vectors`` against the JAX package's: hashes with the
signed-char quirk, subword n-grams, in- and out-of-vocabulary vectors, the
table aligned to a vocabulary from a ``.bin``, a ``.vec`` and a ``.npy``
(within 1e-6), the model files the two writers write (equal bytes), and a
missing file raising."""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu.data import fasttext_bin as jft
from ha2g_tpu.data import vocab as jvocab

from ha2g_torch.data import fasttext_bin as pft
from ha2g_torch.data import vocab as pvocab

WORDS = ["</s>", "hello", "world", "café", "gesture", "you", "ñandú"]
QUERIES = WORDS[1:] + ["unseen", "héllo", "a", "", "naïve-words", "</s>",
                       "日本語"]
TOL = 1e-6


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A model of dim 16, bucket 200, n-grams 3-6, written by the JAX
    package's writer (the port's writes the same bytes)."""
    tmp = tmp_path_factory.mktemp("fasttext")
    rng = np.random.default_rng(7)
    matrix = rng.normal(size=(len(WORDS) + 200, 16)).astype(np.float32)
    path = tmp / "model.bin"
    jft.write_model(path, WORDS, matrix, bucket=200, minn=3, maxn=6,
                    counts=list(range(100, 100 + len(WORDS))))
    pft.write_model(tmp / "port.bin", WORDS, matrix, bucket=200, minn=3,
                    maxn=6, counts=list(range(100, 100 + len(WORDS))))
    assert (tmp / "port.bin").read_bytes() == path.read_bytes()
    return path


@pytest.mark.parametrize("word", QUERIES + ["é", "ÿĀ"])
def test_hash_and_subwords_equal_jax(word):
    data = word.encode("utf-8")
    assert pft.ft_hash(data) == jft.ft_hash(data)
    wrapped = b"<" + data + b">"
    for minn, maxn in ((3, 6), (1, 3), (5, 5)):
        assert pft.compute_subword_hashes(wrapped, minn, maxn) == \
            jft.compute_subword_hashes(wrapped, minn, maxn)


def test_signed_char_quirk():
    """Bytes from 0x80 are sign-extended before the xor (int8 in C++)."""
    h = 2166136261
    for b in "é".encode("utf-8"):
        h = ((h ^ (b | 0xFFFFFF00)) * 16777619) & 0xFFFFFFFF
    assert pft.ft_hash("é".encode("utf-8")) == h


def test_model_and_word_vectors_equal_jax(model):
    pm, jm = pft.load_model(model), jft.load_model(model)
    assert (pm.args, pm.words, pm.counts, pm.nwords, pm.dim) == \
        (jm.args, jm.words, jm.counts, jm.nwords, jm.dim)
    assert isinstance(pm.input, np.memmap)
    for word in QUERIES:
        assert pm.subword_ids(word) == jm.subword_ids(word), word
        np.testing.assert_allclose(pm.get_word_vector(word),
                                   jm.get_word_vector(word), atol=TOL,
                                   rtol=0, err_msg=word)
    # an in-vocabulary word: the mean of its own row and its n-grams'
    ids = pm.subword_ids("hello")
    assert ids[0] == WORDS.index("hello") and len(ids) > 1
    np.testing.assert_allclose(pm.get_word_vector("hello"),
                               np.asarray(pm.input)[ids].mean(0), atol=TOL)
    assert pm.subword_ids("</s>") == [0]


def _vocabs():
    out = []
    for module in (pvocab, jvocab):
        v = module.Vocab("words")
        v.index_words_from_list(QUERIES)
        out.append(v)
    return out


@pytest.mark.parametrize("kind", ["bin", "vec", "npy"])
def test_aligned_table_equals_jax(model, tmp_path, kind):
    pv, jv = _vocabs()
    if kind == "bin":
        path = model
    elif kind == "vec":            # a word per row, some vocabulary missing
        rng = np.random.default_rng(3)
        rows = [f"{w} " + " ".join(f"{x:.6f}" for x in rng.normal(size=16))
                for w in QUERIES[::2] if w]
        path = tmp_path / "vectors.vec"
        path.write_text(f"{len(rows)} 16\n" + "\n".join(rows) + "\n",
                        encoding="utf-8")
    else:
        path = tmp_path / "table.npy"
        np.save(path, np.random.default_rng(4).normal(
            size=(pv.n_words, 16)).astype(np.float32))
    pv.load_word_vectors(path, 16)
    jv.load_word_vectors(path, 16)
    assert pv.word_embedding_weights.shape == (pv.n_words, 16)
    np.testing.assert_allclose(pv.word_embedding_weights,
                               jv.word_embedding_weights, atol=TOL, rtol=0)


def test_wrong_dim_and_missing_file_raise(model, tmp_path):
    pv, _ = _vocabs()
    with pytest.raises(ValueError, match="dim"):
        pv.load_word_vectors(model, 300)
    for name in ("missing.bin", "missing.vec"):
        with pytest.raises(FileNotFoundError):
            pv.load_word_vectors(tmp_path / name, 16)
    with pytest.raises(ValueError, match="fastText"):
        bad = tmp_path / "bad.bin"
        bad.write_bytes(b"\0" * 64)
        pft.load_model(bad)
