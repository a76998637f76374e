"""Clean device case: a port engine on the CPU ingests, commits and
serves a batch; its one transfer is the named fetch stage."""


def test_engine_serves_a_batch(tmp_path):
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    e = Engine(Config(documents_path=str(tmp_path / "docs"),
                      min_doc_capacity=8, min_nnz_capacity=256,
                      min_vocab_capacity=64, query_batch=4,
                      max_query_terms=8, embedding_enabled=False),
               device="cpu")
    for i in range(12):
        e.ingest_text(f"d{i}.txt", f"common token{i} word{i % 3}")
    e.commit()
    hits = e.search_batch(["common", "word1", "token3 word0"], k=5)
    assert [len(h) for h in hits] == [5, 4, 4]
