// Fused ELL block scorer for Hopper (sm_90a): one ELL block's scores,
// written straight into the real-doc score matrix
//
//     out[b, d] = sum_w  qc_t[slot_of[term_t[w, d]], b] * imp_t[w, d]
//
// for the block's live rows d < n_rows, at out + b * ldo + d, where `out`
// points at the block's first column (its row0) inside a [B, doc_cap]
// tensor. Columns outside [0, n_rows) are never touched.
//
// Replaces the TPU kernel behind tfidf_tpu/ops/ell.py:score_block_pallas
// (the pl.pallas_call at ops/ell.py:429, kernel bodies _pallas_kernel_v4
// at :297 and _pallas_kernel (A-build v3) at :262).
//
// What bounds it. Per 512-query batch at the 1M-doc north star the five
// blocks hold ~62M live postings, of which ~32M hit a query term. The
// bytes the function must move (the postings once, ~2 GB of scores
// written once) take ~0.8 ms at the HBM rate, and bound it: a hit's term
// is in only a few of the batch's queries, so the multiplies and adds the
// function needs (one of each per hit and query whose weight is not zero)
// take far less. This kernel does not reach that bound. It multiplies and
// adds every hit by every query of the batch, zero weights included
// (~33G f32 instructions per batch, each its own instruction because the
// order is pinned, no FMA: ~1.0 ms at the unfused issue rate), and
// besides them each hit costs a shared load of the hit, an address and a
// 16-byte weight load per four queries, each (row, lane) a short loop and
// a fold. Skipping the zero-weight (hit, query) products is the lever for
// a next design.
//
// Design: one CTA of 512 threads per tile of R doc rows, and all B queries
// inside the CTA.
//
// 1. Postings are walked once per batch, not once per query tile. Pass 1
//    counts each row's hits per lane; two threads share a row, one taking
//    the lanes at fold positions 0-3 and the other 4-7 (see the fold
//    below), reading term_t/imp_t width-major (neighbouring threads,
//    neighbouring rows: coalesced) and resolving slot_of once per posting.
//    A warp scan turns the counts into offsets. Pass 2 walks the rows again
//    and compacts the hits as (slot, impact) into shared memory, lane by
//    lane in fold order, each lane in w order, padding every lane to an
//    even count with a (slot 0, impact 0) hit so that the hits are taken
//    in pairs below. A CTA whose hits overflow the shared buffer is cut
//    into row chunks.
// 2. Query weights come from shared memory, not L2: they are staged one
//    tile of QT queries at a time, [U_cap][QT] floats, double-buffered
//    with cp.async (the next tile's copy is in flight while the current
//    one is used). QT is 32 when 2 * U_cap * 128 B fits the 128 KiB
//    staging budget, else smaller, down to 1 (U_cap 16384); it is also cut
//    down to the batch for small B. Past that (a batch of more than 16384
//    distinct terms) the same kernel runs unstaged (STAGED = false): QT is
//    32 and each thread reads its four weights of a hit from qc_t through
//    L2, so shared memory no longer depends on U_cap and every batch the
//    kernel envelope admits is scored.
// 3. Registers go to queries, not lanes: G = QT / 4 threads share a row,
//    each holding 4 queries (one 16-byte load per hit). For QT = 32 the 8
//    threads of a row read one slot's 128-byte weight row, so every
//    quarter-warp phase of the shared load touches each bank once,
//    whatever the slots: no bank conflicts. Because the hits arrive lane by
//    lane in fold order, only four partial sums per query are live (not
//    eight lanes). The hit loop reads the next pair of hits ahead of the
//    current pair's arithmetic.
// 4. Scores go straight to the real-doc matrix, live rows only: a small
//    per-warp tile in shared memory turns them into runs of consecutive
//    rows per query (coalesced along d), with the row groups aligned to
//    32-byte sectors of the output, so the misaligned head of an arbitrary
//    row0 is a partial first group. Dead (padded) rows are neither written
//    nor gathered afterwards.
//
// Bit-exactness. The sum is added in the SAME pinned order as the plain
// path's _lane_sum_w (ops/ell.py): entry w goes into lane w % 8, each lane
// adds in increasing w from +0.0, and the lanes fold as
// ((l0+l4)+(l2+l6))+((l1+l5)+(l3+l7)). Taking the lanes in the order
// 0,4,2,6,1,5,3,7 computes exactly that tree: l0; m0 = l0+l4; l2;
// n0 = m0+(l2+l6); l1; m1 = l1+l5; l3; r = n0+(m1+(l3+l7)).
// __fmul_rn / __fadd_rn forbid FMA contraction (the plain path's
// contraction fence), and the build uses no --use_fast_math (flush-to-zero
// would break parity). Skipped and padded products are exactly zero:
// postings whose slot is the zero column (weight 0), postings with impact
// 0 (trailing pads) and the (slot 0, impact 0) pad hits. Impacts and query
// weights are finite and non-negative, so such a product is +0.0 or -0.0;
// a lane sum starts at +0.0 and can never become -0.0, and x + (+-0.0) == x
// for every such x, so skipping or adding them leaves the bits unchanged.
// Staged or read through L2, a weight is the same float, so both modes
// give the same bits. Weights of queries past B are zero (staged: zero-
// filled; unstaged: not read) and their sums are never stored.
//
// A-build variants (kernel_a_build): STEP=1 ("v3") loads one width entry
// per step of the compaction walks; STEP=2 ("v4") loads two entries of a
// lane (w and w + 8), with both slot gathers in flight, before handling
// each in order. The hits and their order are the same, so the variants
// are bit-identical by construction, as on the TPU. The i16 packed-compare
// sub-variant of the TPU v4 is a vreg-packing trick with no counterpart
// here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;                  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageBudget = 128 * 1024;       // both weight buffers
constexpr int kMaxQT = 32;

struct __align__(8) Hit {   // one 8-byte shared load
  int slot;
  float imp;
};

// Tile geometry for a query tile of QT queries.
template <int QT>
struct Geom {
  static constexpr int QQ = QT < 4 ? QT : 4;   // queries per thread
  static constexpr int G = QT / QQ;            // threads per row
  static constexpr int RPI = 32 / G;           // rows per warp step
  static constexpr int RG = RPI > 8 ? RPI : 8; // rows per store group
  static constexpr int R = 2 * kWarps * RG;    // rows per CTA
};

// lane taken at position li of the fold order 0,4,2,6,1,5,3,7 (3-bit
// bit reversal)
__host__ __device__ constexpr int fold_lane(int li) {
  return ((li & 1) << 2) | (li & 2) | ((li >> 2) & 1);
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage qc_t[0:zc, b0:b0+QT] into dst [zc][QT] (queries past B are
// zero-filled) as one cp.async group. `vec`: 16-byte copies (B % 4 == 0
// and qc_t 16-byte aligned).
template <int QT>
__device__ void stage_weights(float* dst, const float* __restrict__ qc_t,
                              int zc, int B, int b0, bool vec) {
  if constexpr (QT >= 4) {
    if (vec) {
      constexpr int C = QT / 4;
      const int n = zc * C;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int s = i / C, j = i % C;
        const int b = b0 + 4 * j;
        const bool ok = b < B;  // B % 4 == 0: a chunk is all in or all out
        cp_async16(dst + s * QT + 4 * j,
                   ok ? qc_t + (size_t)s * B + b : qc_t, ok ? 16 : 0);
      }
      cp_async_commit();
      return;
    }
  }
  const int n = zc * QT;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = i / QT, b = b0 + i % QT;
    const bool ok = b < B;
    cp_async4(dst + i, ok ? qc_t + (size_t)s * B + b : qc_t, ok ? 4 : 0);
  }
  cp_async_commit();
}

template <int QQ>
__device__ __forceinline__ void load_weights(const float* p, float (&v)[QQ]) {
  if constexpr (QQ == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (QQ == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// Unstaged mode: the weights of queries b .. b+QQ-1 at one slot, read
// from row `p` of qc_t through L2; queries past B read as 0. `vec`: the
// row is 16-byte aligned at b (B % 4 == 0, qc_t aligned).
template <int QQ>
__device__ __forceinline__ void load_weights_l2(const float* __restrict__ p,
                                                int b, int B, bool vec,
                                                float (&v)[QQ]) {
  if constexpr (QQ == 4) {
    if (vec) {
      const float4 t = b < B ? __ldg(reinterpret_cast<const float4*>(p + b))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < QQ; ++i) v[i] = b + i < B ? __ldg(p + b + i) : 0.f;
}

// Hits of four lanes whose counts (each <= 32) are packed one per byte.
__device__ __forceinline__ int half_hits(unsigned packed) {
  return (int)((packed * 0x01010101u) >> 24);
}

__device__ __forceinline__ int row_hits(uint2 c) {
  return half_hits(c.x) + half_hits(c.y);
}

// The slot of posting (t, v), or -1 when it cannot add anything: a term
// outside the batch's vocabulary bucket, a non-query term (the zero
// column) or a zero impact.
__device__ __forceinline__ int hit_slot(int t, float v,
                                        const int32_t* __restrict__ slot_of,
                                        int vocab_cap, int zc) {
  if ((unsigned)t >= (unsigned)vocab_cap || v == 0.f) return -1;
  const int s = __ldg(slot_of + t);
  return (unsigned)s < (unsigned)zc ? s : -1;
}

template <int STEP, int QT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
ell_score_kernel(const float* __restrict__ imp_t,      // [W, rows_cap]
                 const int32_t* __restrict__ term_t,   // [W, rows_cap]
                 const int32_t* __restrict__ slot_of,  // [vocab_cap]
                 const float* __restrict__ qc_t,       // [zc+1, B]
                 float* __restrict__ out,              // [B, ldo] at row0
                 long long ldo, int rows_cap, int width, int n_rows,
                 int vocab_cap, int zc, int B, int hits_cap, bool vec) {
  using Gm = Geom<QT>;
  constexpr int R = Gm::R, RG = Gm::RG, RPI = Gm::RPI, G = Gm::G,
                QQ = Gm::QQ;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int qbuf_floats = STAGED ? round16(zc * QT * 4) / 4 : 0;
  float* qbuf = reinterpret_cast<float*>(base);
  // per row: the (padded) hit counts of fold positions 0-3 in .x and 4-7
  // in .y, one byte each
  uint2* lanecnt = reinterpret_cast<uint2*>(base + 8 * qbuf_floats);
  Hit* hits = reinterpret_cast<Hit*>(lanecnt + R);
  float* otile = reinterpret_cast<float*>(hits + hits_cap);
  int* start = reinterpret_cast<int*>(otile + kWarps * QT * RG);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // output columns are grouped from a 32-byte boundary: `head` columns of
  // the first group lie before row0
  const int head = (int)((reinterpret_cast<uintptr_t>(out) >> 2) & 7);
  const int c0 = blockIdx.x * R - head;        // row d of local row 0
  const int ntiles = (B + QT - 1) / QT;

  // the first weight tile is in flight during compaction
  if constexpr (STAGED) stage_weights<QT>(qbuf, qc_t, zc, B, 0, vec);

  // ---- pass 1: hits per row and lane; two threads per row, one for the
  // lanes at fold positions 0-3, one for 4-7 ----
  for (int i = tid; i < 2 * R; i += kThreads) {
    const int r = i % R, half = i / R;
    const int d = c0 + r;
    unsigned packed = 0;
    if (d >= 0 && d < n_rows) {
#pragma unroll
      for (int lj = 0; lj < 4; ++lj) {
        unsigned cnt = 0;
        for (int w0 = fold_lane(4 * half + lj); w0 < width; w0 += 8 * STEP) {
          int t[STEP];
          float v[STEP];
#pragma unroll
          for (int p = 0; p < STEP; ++p) {
            const int w = w0 + 8 * p;
            t[p] = -1;
            v[p] = 0.f;
            if (w < width) {
              const size_t e = (size_t)w * rows_cap + d;
              t[p] = term_t[e];
              v[p] = imp_t[e];
            }
          }
#pragma unroll
          for (int p = 0; p < STEP; ++p)
            cnt += hit_slot(t[p], v[p], slot_of, vocab_cap, zc) >= 0;
        }
        packed |= (cnt + (cnt & 1u)) << (8 * lj);   // padded to even
      }
    }
    reinterpret_cast<unsigned*>(lanecnt)[2 * r + half] = packed;
  }
  __syncthreads();

  // ---- exclusive scan of the row counts (warp 0) ----
  if (warp == 0) {
    constexpr int PER = R / 32;
    int sum = 0;
    for (int i = 0; i < PER; ++i) sum += row_hits(lanecnt[lane * PER + i]);
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int i = 0; i < PER; ++i) {
      start[lane * PER + i] = run;
      run += row_hits(lanecnt[lane * PER + i]);
    }
    if (lane == 31) start[R] = incl;
  }
  __syncthreads();

  if (start[R] == 0) {   // no hits: every live row scores 0
    cp_async_wait<0>();
    for (int i = tid; i < B * R; i += kThreads) {
      const int b = i / R, d = c0 + i % R;
      if (d >= 0 && d < n_rows) out[(size_t)b * ldo + d] = 0.f;
    }
    return;
  }

  const int sub = lane / G;          // row of this thread in a warp step
  const int q0 = (lane % G) * QQ;    // first query of this thread
  float* ot = otile + warp * QT * RG;

  for (int ra = 0; ra < R;) {
    // the chunk [ra, rb): as many rows as fit the hit buffer (one row
    // always fits: the plan keeps hits_cap >= width + 8, a row's most
    // hits with the lane padding)
    int lo = ra + 1, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (start[mid] - start[ra] <= hits_cap) lo = mid; else hi = mid - 1;
    }
    const int rb = lo;
    if constexpr (STAGED) {
      if (ra > 0) stage_weights<QT>(qbuf, qc_t, zc, B, 0, vec);
    }

    // ---- pass 2: compact the chunk's hits, lane by lane in fold order;
    // two threads per row as in pass 1 ----
    for (int i = tid; i < 2 * (rb - ra); i += kThreads) {
      const int r = ra + i % (rb - ra), half = i / (rb - ra);
      const int d = c0 + r;
      if (d < 0 || d >= n_rows) continue;
      Hit* h = hits + (start[r] - start[ra]) +
               (half ? half_hits(lanecnt[r].x) : 0);
#pragma unroll
      for (int lj = 0; lj < 4; ++lj) {
        const Hit* lane_begin = h;
        for (int w0 = fold_lane(4 * half + lj); w0 < width; w0 += 8 * STEP) {
          int t[STEP];
          float v[STEP];
#pragma unroll
          for (int p = 0; p < STEP; ++p) {
            const int w = w0 + 8 * p;
            t[p] = -1;
            v[p] = 0.f;
            if (w < width) {
              const size_t e = (size_t)w * rows_cap + d;
              t[p] = term_t[e];
              v[p] = imp_t[e];
            }
          }
#pragma unroll
          for (int p = 0; p < STEP; ++p) {
            const int s = hit_slot(t[p], v[p], slot_of, vocab_cap, zc);
            if (s >= 0) *h++ = Hit{s, v[p]};
          }
        }
        if ((h - lane_begin) & 1) *h++ = Hit{0, 0.f};
      }
    }

    // ---- query tiles ----
    for (int t = 0; t < ntiles; ++t) {
      [[maybe_unused]] const float* qs = qbuf + (t & 1) * qbuf_floats;
      const int b0 = t * QT;
      if constexpr (STAGED) {
        if (t + 1 < ntiles) {
          stage_weights<QT>(qbuf + ((t + 1) & 1) * qbuf_floats, qc_t, zc,
                            B, b0 + QT, vec);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      }
      __syncthreads();   // tile t (and, at t == 0, the hits) visible

      for (int g = warp; g < R / RG; g += kWarps) {
        const int gr0 = g * RG;
        if (gr0 >= rb || gr0 + RG <= ra) continue;   // warp-uniform
#pragma unroll
        for (int it = 0; it < RG / RPI; ++it) {
          const int r = gr0 + it * RPI + sub;
          const bool in = r >= ra && r < rb;
          const Hit* h = hits + (in ? start[r] - start[ra] : 0);
          const uint2 cn = in ? lanecnt[r] : make_uint2(0u, 0u);
          float a[QQ], c[QQ], e[QQ], cur[QQ];
#pragma unroll
          for (int li = 0; li < 8; ++li) {
            const int n = ((li < 4 ? cn.x : cn.y) >> (8 * (li & 3))) & 0xff;
#pragma unroll
            for (int i = 0; i < QQ; ++i) cur[i] = 0.f;
            int k = 0;
            if (n > 0) {   // n is even
              Hit x0 = h[0], x1 = h[1];
              for (;;) {
                float w0v[QQ], w1v[QQ];
                if constexpr (STAGED) {
                  load_weights<QQ>(qs + x0.slot * QT + q0, w0v);
                  load_weights<QQ>(qs + x1.slot * QT + q0, w1v);
                } else {
                  load_weights_l2<QQ>(qc_t + (size_t)x0.slot * B, b0 + q0,
                                      B, vec, w0v);
                  load_weights_l2<QQ>(qc_t + (size_t)x1.slot * B, b0 + q0,
                                      B, vec, w1v);
                }
                // the next pair, read ahead (past the lane it is unused)
                const Hit y0 = h[k + 2], y1 = h[k + 3];
#pragma unroll
                for (int i = 0; i < QQ; ++i)
                  cur[i] = __fadd_rn(cur[i], __fmul_rn(w0v[i], x0.imp));
#pragma unroll
                for (int i = 0; i < QQ; ++i)
                  cur[i] = __fadd_rn(cur[i], __fmul_rn(w1v[i], x1.imp));
                k += 2;
                if (k == n) break;
                x0 = y0;
                x1 = y1;
              }
            }
            h += n;
            // the fold, lane li of the order 0,4,2,6,1,5,3,7 just ended
#pragma unroll
            for (int i = 0; i < QQ; ++i) {
              switch (li) {
                case 0: a[i] = cur[i]; break;                      // l0
                case 1: a[i] = __fadd_rn(a[i], cur[i]); break;     // m0
                case 2: c[i] = cur[i]; break;                      // l2
                case 3: a[i] = __fadd_rn(a[i], __fadd_rn(c[i], cur[i]));
                        break;                                     // n0
                case 4: c[i] = cur[i]; break;                      // l1
                case 5: c[i] = __fadd_rn(c[i], cur[i]); break;     // m1
                case 6: e[i] = cur[i]; break;                      // l3
                default:                                           // r
                  a[i] = __fadd_rn(a[i],
                                   __fadd_rn(c[i], __fadd_rn(e[i], cur[i])));
              }
            }
          }
#pragma unroll
          for (int i = 0; i < QQ; ++i)
            ot[(q0 + i) * RG + it * RPI + sub] = a[i];
        }
        __syncwarp();
        for (int i = lane; i < QT * RG; i += 32) {
          const int q = i / RG, r = gr0 + i % RG;
          const int d = c0 + r, b = b0 + q;
          if (r >= ra && r < rb && d >= 0 && d < n_rows && b < B)
            out[(size_t)b * ldo + d] = ot[i];
        }
        __syncwarp();
      }
      __syncthreads();   // tile t and the hit buffer are free again
    }
    ra = rb;
  }
}

struct Plan {
  int qt, rows, smem, hits_cap;
  bool staged;
};

// The launch plan for a block: query tile, rows per CTA, dynamic shared
// memory, hit capacity, and whether the weights are staged. The largest
// query tile whose double-buffered staging fits the budget, cut to the
// batch; when not even QT = 1 fits, QT = 32 unstaged (weights read
// through L2). Returns false only when one row's hits cannot fit.
bool make_plan(int zc, int B, int width, int smem_max, Plan* p) {
  // both weight buffers of a QT-query tile (64-bit: zc may be large)
  auto stage_bytes = [zc](int qt) {
    return 2 * (((long long)zc * qt * 4 + 15) & ~15LL);
  };
  int qt = kMaxQT;
  while (qt > 1 && (qt / 2 >= B || stage_bytes(qt) > kStageBudget)) qt /= 2;
  const bool staged = stage_bytes(qt) <= kStageBudget;
  if (!staged) qt = kMaxQT;
  const int qq = qt < 4 ? qt : 4, rpi = 32 / (qt / qq);
  const int rg = rpi > 8 ? rpi : 8, rows = 2 * kWarps * rg;
  const int fixed = (staged ? (int)stage_bytes(qt) : 0) + 8 * rows +
                    4 * kWarps * qt * rg + 4 * (rows + 1);
  const int hits_cap = (smem_max - fixed) / 8;
  if (hits_cap < width + 8) return false;
  p->qt = qt;
  p->rows = rows;
  p->hits_cap = hits_cap;
  p->smem = fixed + 8 * hits_cap;
  p->staged = staged;
  return true;
}

int smem_optin() {
  static int cached = 0;
  if (!cached) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 0;
    cached = v;
  }
  return cached;
}

template <int STEP, int QT, bool STAGED>
int launch(const Plan& p, cudaStream_t stream, const float* imp_t,
           const int32_t* term_t, const int32_t* slot_of, const float* qc_t,
           float* out, long long ldo, int rows_cap, int width, int n_rows,
           int vocab_cap, int zc, int B, bool vec) {
  static int attr_bytes = 0;
  auto* k = ell_score_kernel<STEP, QT, STAGED>;
  if (p.smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = p.smem;
  }
  const int head = (int)((reinterpret_cast<uintptr_t>(out) >> 2) & 7);
  const int grid = (head + n_rows + p.rows - 1) / p.rows;
  k<<<grid, kThreads, p.smem, stream>>>(imp_t, term_t, slot_of, qc_t, out,
                                        ldo, rows_cap, width, n_rows,
                                        vocab_cap, zc, B, p.hits_cap, vec);
  return (int)cudaGetLastError();
}

template <int STEP>
int launch_step(const Plan& p, cudaStream_t s, const float* imp_t,
                const int32_t* term_t, const int32_t* slot_of,
                const float* qc_t, float* out, long long ldo, int rows_cap,
                int width, int n_rows, int vocab_cap, int zc, int B,
                bool vec) {
#define ELL_LAUNCH(Q)                                                       \
  case Q:                                                                   \
    return launch<STEP, Q, true>(p, s, imp_t, term_t, slot_of, qc_t, out,  \
                                 ldo, rows_cap, width, n_rows, vocab_cap,  \
                                 zc, B, vec);
  if (!p.staged)
    return launch<STEP, kMaxQT, false>(p, s, imp_t, term_t, slot_of, qc_t,
                                       out, ldo, rows_cap, width, n_rows,
                                       vocab_cap, zc, B, vec);
  switch (p.qt) {
    ELL_LAUNCH(32)
    ELL_LAUNCH(16)
    ELL_LAUNCH(8)
    ELL_LAUNCH(4)
    ELL_LAUNCH(2)
    ELL_LAUNCH(1)
  }
#undef ELL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan the launcher would use: out5 = {query tile, rows per CTA,
// dynamic shared-memory bytes, hit capacity, weights staged (1) or read
// through L2 (0)}. Returns 0, or cudaErrorInvalidValue for arguments the
// launcher refuses.
extern "C" int ell_score_plan(int u1, int B, int width, int* out5) {
  Plan p;
  const int smax = smem_optin();
  if (u1 < 1 || B < 1 || width < 1 || smax == 0 ||
      !make_plan(u1 - 1, B, width, smax, &p))
    return (int)cudaErrorInvalidValue;
  out5[0] = p.qt;
  out5[1] = p.rows;
  out5[2] = p.smem;
  out5[3] = p.hits_cap;
  out5[4] = p.staged ? 1 : 0;
  return 0;
}

// Plain C entry point (bound with ctypes). `out` points at column row0 of
// a [B, ldo] f32 tensor; rows d < n_rows are written at out + b*ldo + d.
// `step` is 1 (v3) or 2 (v4); u1 = U_cap + 1 rows of qc_t, the last being
// the zero column. Returns cudaGetLastError() after the launch (0 on
// success); the caller raises.
extern "C" int ell_score_launch(const float* imp_t, const int32_t* term_t,
                                const int32_t* slot_of, const float* qc_t,
                                float* out, long long ldo, int rows_cap,
                                int width, int n_rows, int vocab_cap, int u1,
                                int B, int step, void* stream) {
  Plan p;
  const int smax = smem_optin();
  if (rows_cap <= 0 || width <= 0 || B <= 0 || u1 <= 0 || n_rows <= 0 ||
      n_rows > rows_cap || ldo < n_rows || (step != 1 && step != 2) ||
      smax == 0 || !make_plan(u1 - 1, B, width, smax, &p))
    return (int)cudaErrorInvalidValue;
  const bool vec = (B % 4) == 0 &&
                   (reinterpret_cast<uintptr_t>(qc_t) % 16) == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (step == 1)
    return launch_step<1>(p, s, imp_t, term_t, slot_of, qc_t, out, ldo,
                          rows_cap, width, n_rows, vocab_cap, u1 - 1, B, vec);
  return launch_step<2>(p, s, imp_t, term_t, slot_of, qc_t, out, ldo,
                        rows_cap, width, n_rows, vocab_cap, u1 - 1, B, vec);
}
