"""The port's native C++ tokenizer, held to the port's Python analyzer and
to the JAX package's ``tfidf_tpu.native`` on the same texts.

Exact: ids, tfs and lengths are integers and integer-valued floats, so
every comparison is equality. The library is built with ``g++`` from the
port's own copy of the source into ``build/native/`` (gitignored); the
tests skip, with the reason, where there is no compiler.
"""

import os

import numpy as np
import pytest

from tests.test_native import TRICKY
from tfidf_tpu import native as jax_native
from tfidf_tpu_torch import native
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.engine.vocab import NativeVocabulary
from tfidf_tpu_torch.ops.analyzer import Analyzer
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.metrics import global_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def built():
    if not native.available():
        pytest.skip("no C++ compiler: the native tokenizer is built with "
                    "g++ at first use")


def _zipf_texts(seed, n=60):
    rng = np.random.default_rng(seed)
    words = ["alpha", "Beta", "can't", "3.14", "x_y", "gamma,", "delta.",
             "EPSILON", "1,000", "o'clock", "zeta"]
    return [" ".join(words[i] for i in rng.zipf(1.3, int(rng.integers(
        1, 80))) % len(words)) + f" tok{k}" for k in range(n)]


def _native_counts(ne, text):
    ids, tfs, length = ne.analyze(text, add=True)
    terms = ne.dump_terms()
    return {terms[int(i)]: float(f) for i, f in zip(ids, tfs)}, length, ids


@pytest.mark.parametrize("text", TRICKY + _zipf_texts(1, 6))
def test_native_equals_python_analyzer_and_reference(built, text):
    ne = native.NativeEngine()
    got, length, ids = _native_counts(ne, text)
    want = {t: float(c) for t, c in Analyzer().counts(text).items()}
    assert got == want
    assert length == sum(want.values())
    assert list(ids) == sorted(ids)
    if jax_native.available():
        ref = jax_native.NativeEngine()
        r_ids, r_tfs, r_len = ref.analyze(text, add=True)
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_array_equal(ne.analyze(text, add=False)[1], r_tfs)
        assert length == r_len and ne.dump_terms() == ref.dump_terms()


def test_stopwords_and_token_cap_match(built):
    kw = dict(stopwords=("the", "and"), max_token_length=4)
    ne = native.NativeEngine(**kw)
    text = "the miserable and gigantic theand"
    got, length, _ = _native_counts(ne, text)
    want = Analyzer(stopwords=frozenset(kw["stopwords"]),
                    max_token_length=4).counts(text)
    assert got == {t: float(c) for t, c in want.items()}
    assert length == sum(want.values())


def test_non_ascii_falls_through_to_python(built):
    ne = native.NativeEngine()
    assert ne.analyze("café au lait", add=True) is None
    e = Engine(Config(embedding_enabled=False, min_vocab_capacity=32,
                      min_doc_capacity=8, min_nnz_capacity=64),
               device="cpu")
    assert isinstance(e.vocab, NativeVocabulary)
    fast = global_metrics.get("ingest_native_fast_path")
    slow = global_metrics.get("ingest_python_fallback")
    e.ingest_text("a.txt", "plain ascii words")
    e.ingest_text("b.txt", "naïve café words")
    assert global_metrics.get("ingest_native_fast_path") == fast + 1
    assert global_metrics.get("ingest_python_fallback") == slow + 1
    e.commit()
    assert [h.name for h in e.search("words", k=5)] == ["a.txt", "b.txt"]
    assert e.search("café")[0].name == "b.txt"


def test_library_built_under_gitignored_build_dir(built):
    path = native.lib_path()
    assert os.path.isfile(path)
    rel = os.path.relpath(path, ROOT)
    assert rel.split(os.sep)[:2] == ["build", "native"]
    with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as f:
        assert "build/" in f.read().split(), f"{rel} is not gitignored"
    # nothing is built beside the source
    assert not [n for n in os.listdir(os.path.dirname(native.__file__))
                if n.endswith(".so")]


def test_native_and_python_engines_serve_identically(built):
    """Same documents through the native engine and a native_ingest=False
    engine: the same vocabulary ids in the same order, the same hits to
    the bit."""
    docs = {f"d{i}": t for i, t in enumerate(_zipf_texts(2, 200))}
    docs["u"] = "naïve alpha"          # one non-ASCII document
    cfg = dict(embedding_enabled=False, min_vocab_capacity=32,
               min_doc_capacity=256, min_nnz_capacity=64, query_batch=16)
    a = Engine(Config(**cfg), device="cpu")
    b = Engine(Config(**dict(cfg, native_ingest=False)), device="cpu")
    assert a.native is not None and b.native is None
    for e in (a, b):
        for name, text in docs.items():
            e.ingest_text(name, text)
        e.commit()
    assert a.vocab.all_terms() == b.vocab.all_terms()
    queries = ["alpha beta", "can't", "3.14 zeta", "tok7", "naïve"]
    assert a.search_batch(queries) == b.search_batch(queries)


def test_native_vocabulary_lookups_match_the_table(built):
    """Query-side lookups (served from the found-id cache after the
    first) always equal the native table's, including terms that appear
    only after a first unknown lookup."""
    v = NativeVocabulary(native.NativeEngine())
    ids = [v.add(t) for t in ("alpha", "beta", "gamma")]
    assert ids == [0, 1, 2]
    assert v.lookup("delta") is None
    for _ in range(2):
        assert [v.lookup(t) for t in ("alpha", "beta", "gamma")] == ids
    assert v.add("delta") == 3 and v.lookup("delta") == 3
    assert v.all_terms() == ["alpha", "beta", "gamma", "delta"]
    assert v.map_counts({"beta": 2, "zeta": 1}, add=False) == {1: 2}
