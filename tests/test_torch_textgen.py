"""The port's realistic-corpus generator against the JAX package's.

``tfidf_tpu_torch/utils/textgen.py`` is a copy of
``tfidf_tpu/utils/textgen.py`` (the copy check in
``test_torch_cluster_copy.py`` holds its code). Here it is held on data:
the lexicon harvested from the files of the machine the test runs on is
the same list with the same counts, and the same seed draws the same
payload bytes. The
payload-kind contract of ``tests/test_textgen.py`` then holds through the
port's own extractors: binary refused (415), latin-1 not UTF-8 and read
through the charset fallback, html reduced to its body.
"""

import numpy as np
import pytest

from tfidf_tpu.ops.analyzer import extract_text as jax_extract_text
from tfidf_tpu.utils import textgen as jax_textgen
from tfidf_tpu_torch.ops.analyzer import UnsupportedMediaType, extract_text
from tfidf_tpu_torch.utils import textgen


@pytest.fixture(scope="module")
def lexicons():
    return (textgen.harvest_lexicon(max_words=5000),
            jax_textgen.harvest_lexicon(max_words=5000))


def test_lexicon_equals_the_jax_harvest(lexicons):
    (words, counts), (jwords, jcounts) = lexicons
    assert len(words) >= 1000
    assert words == jwords
    assert counts.dtype == jcounts.dtype
    assert np.array_equal(counts, jcounts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_payloads_byte_equal_to_jax(lexicons, seed):
    words = lexicons[0][0]
    gen = textgen.RealisticCorpus(np.random.default_rng(seed), words)
    jgen = jax_textgen.RealisticCorpus(np.random.default_rng(seed), words)
    assert np.array_equal(gen.p, jgen.p)
    for i in range(500):
        # the bench's fractions, then raised ones so every kind shows
        kw = {} if i % 2 else dict(html_frac=0.2, latin1_frac=0.2,
                                   binary_frac=0.1)
        got = gen.make_payload(40 + i % 60, **kw)
        want = jgen.make_payload(40 + i % 60, **kw)
        assert got == want, (seed, i)


def test_payload_kinds_through_the_port_extractors(lexicons):
    gen = textgen.RealisticCorpus(np.random.default_rng(0), lexicons[0][0])
    seen = set()
    for _ in range(800):
        payload, kind = gen.make_payload(
            40, html_frac=0.2, latin1_frac=0.2, binary_frac=0.1)
        seen.add(kind)
        if kind == "binary":
            with pytest.raises(UnsupportedMediaType):
                extract_text(payload)
            continue
        text = extract_text(payload)
        assert text == jax_extract_text(payload)
        if kind == "latin1":
            with pytest.raises(UnicodeDecodeError):
                payload.decode("utf-8")
            assert "caf\xe9" in text
        elif kind == "html":
            assert payload.lstrip().lower().startswith(b"<html")
            assert "<p>" not in text and "p{margin:0}" not in text
            assert len(text.split()) > 5
        else:
            assert text == payload.decode("utf-8")
    assert seen == {"plain", "html", "latin1", "binary"}


def test_text_shape_equals_jax(lexicons):
    words = lexicons[0][0]
    gen = textgen.RealisticCorpus(np.random.default_rng(1), words)
    jgen = jax_textgen.RealisticCorpus(np.random.default_rng(1), words)
    texts = [gen.make_text(80) for _ in range(20)]
    assert texts == [jgen.make_text(80) for _ in range(20)]
    text = "\n".join(texts)
    assert "." in text and "," in text and "'" in text
    assert any(c.isdigit() for c in text)
