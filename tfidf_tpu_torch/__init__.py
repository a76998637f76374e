"""tfidf_tpu_torch — the PyTorch/CUDA port of :mod:`tfidf_tpu`.

Same sub-package layout and module names as the JAX package, so each
counterpart is found at once:

    utils     config (same fields and ``TFIDF_*`` overrides), metrics,
              logging, tracing (``torch.profiler`` ranges)
    models    scoring model families (numpy only)
    ops       analyzer, COO helpers, scoring, top-k, blocked ELL and the
              hand-written Hopper kernel behind it (``csrc/``), the
              chunked dense top-k
    engine    vocabulary, shard index, pipelined searcher, embedder and
              embedding column (the dense plane), checkpoints, compute
              health, engine facade

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there is no silent CPU fallback (:mod:`tfidf_tpu_torch.device`). The
port imports nothing of ``jax`` or ``tfidf_tpu``.

Importing this package loads nothing heavy and needs no CUDA.
"""

__version__ = "0.1.0"
