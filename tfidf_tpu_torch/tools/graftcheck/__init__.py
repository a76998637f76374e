"""graftcheck for the PyTorch/CUDA port: static analysis of the
``tfidf_tpu_torch`` tree and its runtime witnesses.

Nine analyzers, each an AST pass over the package (the code under
analysis is parsed, never imported, so the suite runs without torch or a
card); the root ``tools/graftcheck`` runs the same passes over the JAX
package:

- ``lockgraph``   — cross-module lock-acquisition-order graph: cycles,
  blocking calls inside a held-lock region, indefinite waits;
- ``jitpurity``   — code captured by ``torch.compile`` / ``torch.jit``
  or a CUDA graph must not touch locks, metrics, fault points, the wall
  clock or mutable module globals;
- ``devicecheck`` — kernel builds and loads only through ``kernels.py``,
  capacity-keyed caches, no implicit device sync in the serving cone
  outside the fetch stage, the in-place audit;
- ``registry_drift`` — fault points, ``Config`` fields and metrics
  against their registries and the README;
- ``resilience``  — every leader->worker RPC through
  ``ClusterResilience.worker_call``;
- ``wallclock``   — no wall-clock deadline arithmetic;
- ``protocol``    — the wire contract (endpoints, headers, statuses,
  seams, versions) against the README's ``## Wire contract``;
- ``deadsymbols`` — functions and methods nothing references;
- ``storageseam`` — durable writes only through ``utils/storage.py``.

Intentional findings are pinned in two committed data files next to
this package: ``allowlist.json`` (reviewed-intentional, with a reason
per entry — never reported) and ``baseline.json`` (tolerated until fixed,
each with a ROADMAP queue line — reported as baselined). Any finding in
neither file fails the run. Keys are stable (no line numbers).

Run as ``python -m tfidf_tpu_torch.tools.graftcheck`` (see
``__main__``) or through ``tests/test_torch_graftcheck.py``. The runtime
halves — the lockdep, protocol and device witnesses — live in
``witness``, ``protocol_witness`` and ``device_witness``.
"""

from tfidf_tpu_torch.tools.graftcheck.core import (
    Finding, SourceTree, load_allowlist, load_baseline, run_analyzers)

__all__ = ["Finding", "SourceTree", "load_allowlist", "load_baseline",
           "run_analyzers"]
