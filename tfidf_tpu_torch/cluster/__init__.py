"""See the package docstring of tfidf_tpu_torch."""
