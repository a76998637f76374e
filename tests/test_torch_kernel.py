"""The ELL block kernel's plain version held against the Pallas kernel.

On the CPU ``score_block_kernel`` runs its plain PyTorch version; here it
goes over the same ``T1_CASES`` matrix as ``tests/test_kernel_parity.py``
(eligibility edges, odd widths, ragged pads, U_cap 256/1024, vocabularies
on both sides of 2^15), against ``score_block_pallas`` in interpret mode.
Tolerance: max abs < 1e-4 and identical top-10 — the KERNEL_PARITY.json
class, because the Pallas kernel contracts on the MXU in another order.
Against the JAX XLA path (``_score_block``) the plain version is bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests.test_kernel_parity import T1_CASES  # puts the repo root on path
from kernel_parity import make_case  # noqa: E402
from tfidf_tpu.ops import ell as j_ell
from tfidf_tpu.ops import scoring as j_scoring
from tfidf_tpu_torch.ops import ell as t_ell
from tfidf_tpu_torch.ops import scoring as t_scoring

TOP_K = 10


def _port_batch(qb):
    n = int(qb.n_uniq)
    return t_scoring.QueryBatch(
        uniq=torch.from_numpy(np.array(qb.uniq)), n_uniq=n,
        slots=torch.from_numpy(np.array(qb.slots)),
        weights=torch.from_numpy(np.array(qb.weights)),
        uniq_host=np.asarray(qb.uniq[:n], np.int64))


@pytest.mark.parametrize("i", range(len(T1_CASES)))
def test_plain_kernel_vs_pallas_interpret(i):
    case = T1_CASES[i]
    rng = np.random.default_rng(100 + i)
    imp, term, qb = make_case(rng, **case)
    vocab = case.get("vocab", 500_000)
    n_rows = case["n_rows"]
    jq = j_scoring.QueryBatch(*(jnp.asarray(x) for x in qb))
    slot_j, qc_j = j_scoring._compile_queries(jq, vocab)
    pallas = np.asarray(j_ell.score_block_pallas(
        jnp.asarray(imp), jnp.asarray(term), jq.uniq, jq.n_uniq, qc_j,
        jnp.int32(n_rows), a_build="v4", vocab_cap=vocab))[:, :n_rows]
    xla = np.asarray(j_ell._score_block(
        jnp.asarray(imp), jnp.asarray(term), slot_j, qc_j.T,
        2048))[:, :n_rows]

    slot_t, qc_ext = t_scoring._compile_queries(_port_batch(qb), vocab)
    qc_t = qc_ext.T.contiguous()
    imp_t = torch.from_numpy(np.ascontiguousarray(imp.T))
    term_t = torch.from_numpy(np.ascontiguousarray(term.T))
    B, rows_cap = qc_t.shape[1], imp_t.shape[1]
    outs = {a: t_ell.score_block_kernel(
                imp_t, term_t, slot_t, qc_t, n_rows, a_build=a,
                out=torch.full((B, rows_cap), -7.0)).numpy()
            for a in t_ell.A_BUILD_VARIANTS}
    np.testing.assert_array_equal(outs["v3"], outs["v4"])
    got = outs["v4"]
    assert (got[:, n_rows:] == -7.0).all()    # dead rows are not written
    got = got[:, :n_rows]
    np.testing.assert_array_equal(got, xla)   # bitwise vs the XLA path
    assert np.max(np.abs(got - pallas)) < 1e-4
    k = min(TOP_K, n_rows)
    np.testing.assert_array_equal(
        np.argsort(-got, axis=1, kind="stable")[:, :k],
        np.argsort(-pallas, axis=1, kind="stable")[:, :k])
