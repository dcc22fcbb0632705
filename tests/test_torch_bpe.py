"""``utils/bpe.py`` of the port against the JAX package's: both train the
same merges on the vendored corpus, encode and decode it identically, and
each loads the other's saved tokenizer file."""
import gzip
import os

import numpy as np
import pytest

from deepspeed_tpu.utils.bpe import ByteBPE as JBPE
from deepspeed_tpu_torch.utils.bpe import ByteBPE as TBPE

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


@pytest.fixture(scope="module")
def corpus():
    with gzip.open(os.path.join(DATA, "corpus.txt.gz"), "rt",
                   encoding="utf-8") as f:
        return f.read(200_000)


@pytest.fixture(scope="module")
def trained(corpus):
    return JBPE.train(corpus, vocab_size=600), TBPE.train(corpus,
                                                          vocab_size=600)


def test_same_merges_on_the_vendored_corpus(trained):
    j, t = trained
    assert j.merges == t.merges
    assert j.vocab_size == t.vocab_size == 600


def test_same_encode_and_decode(trained, corpus):
    j, t = trained
    text = corpus[:50_000] + " naive café — δx ≈ 0.1!\n\n    indented"
    ids = t.encode(text)
    assert ids == j.encode(text)
    assert t.decode(ids) == j.decode(ids) == text


def test_vendored_tokenizer_encodes_the_committed_tokens(corpus):
    """Both packages load ``data/tokenizer.json`` and produce the
    committed token stream's prefix."""
    tokens = np.load(os.path.join(DATA, "tokens.npz"))["tokens"]
    n = 20_000 - 64
    for cls in (JBPE, TBPE):
        bpe = cls.load(os.path.join(DATA, "tokenizer.json"))
        assert bpe.vocab_size == 4096
        assert bpe.encode(corpus)[:n] == tokens[:n].tolist()


@pytest.mark.parametrize("saver,loader", [(TBPE, JBPE), (JBPE, TBPE)])
def test_saved_file_loads_in_the_other_package(tmp_path, trained, corpus,
                                               saver, loader):
    src = trained[1] if saver is TBPE else trained[0]
    path = str(tmp_path / "tok.json")
    src.save(path)
    back = loader.load(path)
    assert back.merges == src.merges
    assert back.encode(corpus[:5000]) == src.encode(corpus[:5000])
    # and back again: the round trip is byte-stable
    path2 = str(tmp_path / "tok2.json")
    back.save(path2)
    with open(path, "rb") as a, open(path2, "rb") as b:
        assert a.read() == b.read()
