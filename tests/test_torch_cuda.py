"""Tests of the port that need the card (marker ``cuda``).

The CUDA kernel has no interpret mode, and the top-k's tie rule matters
where ``torch.topk`` gives no tie order, so these skip, with the reason,
where ``torch.cuda.is_available()`` is false. On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda

The decision is made inside the fixture, never at import time.
"""

import numpy as np
import pytest
import torch

from tfidf_tpu_torch.ops import ell as E
from tfidf_tpu_torch.ops import scoring as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these run the ELL kernel and the "
                    "top-k on CUDA tensors")
    return torch.device("cuda")


def _block(rng, rows_cap, width, B, vocab=50_000):
    term = (rng.integers(0, vocab // width, size=(rows_cap, width))
            * width + np.arange(width)).astype(np.int32)
    imp = rng.random((rows_cap, width), dtype=np.float32)
    q_terms = np.zeros((B, 4), np.int32)
    q_weights = np.zeros((B, 4), np.float32)
    for i in range(B):
        q_terms[i, :2] = [term[rng.integers(rows_cap), 0],
                          term[rng.integers(rows_cap), 1]]
        q_weights[i, :2] = 1.0
    return imp, term, q_terms, q_weights, vocab


@pytest.mark.parametrize("B", [1, 3, 64, 512])
def test_kernel_bitwise_equal_to_plain_on_card(cuda, B):
    """Exact: the kernel adds in the plain version's pinned lane order
    without FMA contraction."""
    rng = np.random.default_rng(B)
    imp, term, qt, qw, vocab = _block(rng, 768, 33, B)
    qb = S.make_query_batch(qt, qw, device=cuda)
    slot_of, qc_ext = S._compile_queries(qb, vocab)
    qc_t = qc_ext.T.contiguous()
    imp_t = torch.from_numpy(np.ascontiguousarray(imp.T)).to(cuda)
    term_t = torch.from_numpy(np.ascontiguousarray(term.T)).to(cuda)
    E.reset_launches()
    outs = [E.score_block_kernel(imp_t, term_t, slot_of, qc_t, 700,
                                 a_build=a) for a in ("v3", "v4")]
    assert E.launches == {"v3": 1, "v4": 1}
    plain = E.score_block_plain(imp_t, term_t, slot_of, qc_t, 700)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], plain) and torch.equal(outs[1], plain)
    assert int((plain > 0).sum()) > 0


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    imp_t = torch.rand(8, 256, device=cuda)
    term_t = torch.zeros(8, 256, dtype=torch.int32, device=cuda)
    slot_of = torch.zeros(100, dtype=torch.int32, device=cuda)
    qc_t = torch.zeros(257, 4, device=cuda)
    with pytest.raises(ValueError, match="term_t"):
        E.score_block_kernel(imp_t, term_t.long(), slot_of, qc_t, 10)
    with pytest.raises(ValueError, match="contiguous"):
        E.score_block_kernel(imp_t.T.contiguous().T, term_t, slot_of,
                             qc_t, 10)
    with pytest.raises(ValueError, match="cpu"):
        E.score_block_kernel(imp_t, term_t, slot_of.cpu(), qc_t, 10)


def _ref_topk(s, num_docs, k):
    """numpy top-k with the reference's tie rule (score desc, id asc)."""
    s = s[:num_docs]
    order = np.lexsort((np.arange(s.shape[0]), -s))[:k]
    return s[order], order.astype(np.int32)


@pytest.mark.parametrize("doc_cap,chunk,num_docs", [
    (300_007, 1 << 17, 300_000),           # clamped tail over chunk 2
    ((1 << 23) + 3001, 1 << 21, (1 << 23) + 3000),   # ids past 2^23
])
def test_packed_topk_chunked_tie_rule_on_card(cuda, doc_cap, chunk,
                                              num_docs):
    """Exact: on tie-heavy scores the card's top-k equals a numpy
    lexsort, ids and value bits, so equal scores rank by ascending id."""
    from tfidf_tpu_torch.ops import topk as T
    rng = np.random.default_rng(doc_cap)
    s = rng.integers(0, 3, size=(4, doc_cap)).astype(np.float32) * 0.5
    for r in range(4):
        s[r, rng.integers(doc_cap - chunk, doc_cap, 12)] = 2.0
    vals, ids = T.unpack_topk(T.packed_topk_chunked(
        torch.from_numpy(s).to(cuda), num_docs, k=10, chunk=chunk))
    for r in range(4):
        want_v, want_i = _ref_topk(s[r], num_docs, 10)
        np.testing.assert_array_equal(ids[r], want_i)
        np.testing.assert_array_equal(vals[r].view(np.int32),
                                      want_v.view(np.int32))
