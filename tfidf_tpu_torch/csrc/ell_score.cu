// Fused ELL block scorer for Hopper (sm_90a): one ELL block's scores
//
//     out[b, d] = sum_w  qc_t[slot_of[term_t[w, d]], b] * imp_t[w, d]
//
// Replaces the TPU kernel behind tfidf_tpu/ops/ell.py:score_block_pallas
// (the pl.pallas_call at ops/ell.py:429, kernel bodies _pallas_kernel_v4
// at :297 and _pallas_kernel (A-build v3) at :262).
//
// Design. The TPU kernel exists to avoid gathers, which are slow there: it
// builds a dense slot-impact tile with compares and contracts it on the MXU.
// On this card gathers through L2 are cheap, so the kernel gathers
// directly: the batch-wide slot_of [vocab_cap] (built once per batch by
// _compile_queries) replaces the uniq compare, and qc_t [U_cap+1, B] (the
// transposed qc_ext) gives each thread contiguous weights for its query
// tile. At the north-star size both are ~2 MB and stay resident in the
// 50 MB L2. Non-query and pad terms map to the zero column U_cap, exactly
// the TPU kernel's -1 uniq sentinel (ops/ell.py:396-398).
//
// One thread per doc row d, walking w for a tile of kTB queries. Term and
// impact arrive width-major ([W, rows_cap], the TPU launcher's impact.T,
// built once at commit), so neighbouring threads read neighbouring
// addresses at the same w and every output store is coalesced. Rows
// d >= n_rows write 0 without reading postings (the TPU's dead-tile skip).
//
// Bit-exactness. Each product is added into the SAME pinned order as the
// plain path's _lane_sum_w (ops/ell.py): entry w goes into lane w % 8, and
// the 8 lanes are folded by a halving tree ((l0+l4)+(l2+l6))+((l1+l5)+(l3+l7)).
// __fmul_rn / __fadd_rn forbid FMA contraction (the plain path's
// contraction fence, ops/ell.py:522-531), and the build uses no
// --use_fast_math (flush-to-zero would break parity). Entries whose slot is
// the zero column are skipped: their product is +0.0 and adding +0.0 to a
// finite sum leaves its bits unchanged, so the result stays bit-identical to
// the plain path for finite impacts (impacts are finite by construction).
//
// A-build variants (kernel_a_build): STEP=1 ("v3") takes one width entry
// per step; STEP=2 ("v4") loads two entries, with both slot gathers and
// both weight loads in flight, before adding each into its own lane. The
// addition order per lane is the same, so the variants are bit-identical by
// construction, as on the TPU. The i16 packed-compare sub-variant of the TPU
// v4 is a vreg-packing trick with no counterpart here.
//
// Bound on this card. Per block the kernel reads ~8 bytes per live padded
// entry (term + impact) plus the L2-resident slot_of / qc_t, and writes
// B * rows_cap * 4 bytes of scores. At B=512 over 1M docs (~1.57M padded
// rows) the output write is ~3.2 GB per batch against ~0.6 GB of postings,
// so the output write, not the postings read, sets the bound (~1 ms at
// 3.35 TB/s). This first kernel re-walks a row's postings once per query
// tile and is far from that bound; fusing top-k so the [B, rows_cap]
// scores never reach HBM, and a wgmma contraction over a dense A tile, are
// the planned redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;          // _RED_LANES of the plain path
constexpr int kRowsPerBlock = 128; // doc rows (threads) per block
constexpr int kTB = 8;             // queries per accumulator tile
constexpr int kQG = 64;            // queries per block along grid.y

template <int STEP, bool VEC>
__global__ void __launch_bounds__(kRowsPerBlock)
ell_score_kernel(const float* __restrict__ imp_t,      // [W, rows_cap]
                 const int32_t* __restrict__ term_t,   // [W, rows_cap]
                 const int32_t* __restrict__ slot_of,  // [vocab_cap]
                 const float* __restrict__ qc_t,       // [U_cap+1, B]
                 float* __restrict__ out,              // [B, rows_cap]
                 int rows_cap, int width, int n_rows, int vocab_cap,
                 int zero_col, int B) {
  const int d = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (d >= rows_cap) return;
  const int q_lo = blockIdx.y * kQG;
  const int q_hi = min(q_lo + kQG, B);
  if (d >= n_rows) {
    for (int b = q_lo; b < q_hi; ++b) out[(size_t)b * rows_cap + d] = 0.f;
    return;
  }
  for (int b0 = q_lo; b0 < q_hi; b0 += kTB) {
    float acc[kLanes][kTB];
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
#pragma unroll
      for (int i = 0; i < kTB; ++i) acc[j][i] = 0.f;

    for (int w0 = 0; w0 < width; w0 += kLanes) {
#pragma unroll
      for (int j = 0; j < kLanes; j += STEP) {
        int s[STEP];
        float v[STEP];
#pragma unroll
        for (int p = 0; p < STEP; ++p) {
          const int w = w0 + j + p;
          s[p] = zero_col;
          v[p] = 0.f;
          if (w < width) {
            const size_t e = (size_t)w * rows_cap + d;
            const int t = term_t[e];
            v[p] = imp_t[e];
            s[p] = ((unsigned)t < (unsigned)vocab_cap) ? slot_of[t]
                                                       : zero_col;
          }
        }
#pragma unroll
        for (int p = 0; p < STEP; ++p) {
          if (s[p] == zero_col) continue;
          const float* q = qc_t + (size_t)s[p] * B + b0;
          float qv[kTB];
          if (VEC) {
            const float4 a = reinterpret_cast<const float4*>(q)[0];
            const float4 c = reinterpret_cast<const float4*>(q)[1];
            qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
            qv[4] = c.x; qv[5] = c.y; qv[6] = c.z; qv[7] = c.w;
          } else {
#pragma unroll
            for (int i = 0; i < kTB; ++i)
              qv[i] = (b0 + i < q_hi) ? q[i] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kTB; ++i)
            acc[j + p][i] = __fadd_rn(acc[j + p][i], __fmul_rn(qv[i], v[p]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      if (!VEC && b0 + i >= q_hi) break;
      const float m0 = __fadd_rn(acc[0][i], acc[4][i]);
      const float m1 = __fadd_rn(acc[1][i], acc[5][i]);
      const float m2 = __fadd_rn(acc[2][i], acc[6][i]);
      const float m3 = __fadd_rn(acc[3][i], acc[7][i]);
      const float r = __fadd_rn(__fadd_rn(m0, m2), __fadd_rn(m1, m3));
      out[(size_t)(b0 + i) * rows_cap + d] = r;
    }
  }
}

template <int STEP>
void launch(bool vec, dim3 grid, cudaStream_t stream, const float* imp_t,
            const int32_t* term_t, const int32_t* slot_of, const float* qc_t,
            float* out, int rows_cap, int width, int n_rows, int vocab_cap,
            int zero_col, int B) {
  if (vec)
    ell_score_kernel<STEP, true><<<grid, kRowsPerBlock, 0, stream>>>(
        imp_t, term_t, slot_of, qc_t, out, rows_cap, width, n_rows,
        vocab_cap, zero_col, B);
  else
    ell_score_kernel<STEP, false><<<grid, kRowsPerBlock, 0, stream>>>(
        imp_t, term_t, slot_of, qc_t, out, rows_cap, width, n_rows,
        vocab_cap, zero_col, B);
}

}  // namespace

// Plain C entry point (bound with ctypes). `step` is 1 (v3) or 2 (v4);
// u1 = U_cap + 1 rows of qc_t, the last being the zero column. Returns
// cudaGetLastError() after the launch (0 on success); the caller raises.
extern "C" int ell_score_launch(const float* imp_t, const int32_t* term_t,
                                const int32_t* slot_of, const float* qc_t,
                                float* out, int rows_cap, int width,
                                int n_rows, int vocab_cap, int u1, int B,
                                int step, void* stream) {
  if (rows_cap <= 0 || width <= 0 || B <= 0 || u1 <= 0 ||
      (step != 1 && step != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((rows_cap + kRowsPerBlock - 1) / kRowsPerBlock,
                  (B + kQG - 1) / kQG);
  // float4 weight loads need every tile start 16-byte aligned and full
  const bool vec = (B % kTB) == 0 &&
                   (reinterpret_cast<uintptr_t>(qc_t) % 16) == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (step == 1)
    launch<1>(vec, grid, s, imp_t, term_t, slot_of, qc_t, out, rows_cap,
              width, n_rows, vocab_cap, u1 - 1, B);
  else
    launch<2>(vec, grid, s, imp_t, term_t, slot_of, qc_t, out, rows_cap,
              width, n_rows, vocab_cap, u1 - 1, B);
  return (int)cudaGetLastError();
}
