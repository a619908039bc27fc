// Tensor-core attention tile shared by the bf16 bodies of the two prefill
// kernels: paged_prefill.cu (keys through the run tables of the layer-major
// pool) and prefix_attention.cu (contiguous [prefix ‖ new] keys).  Only the
// loader differs between them: which keys go into a pipeline stage, and
// where they are read from.
//
// Bound on Hopper: operations for long chunks (4 * hd flops per visible
// query-key pair against 2 * hd K/V elements per key, far above the ~295
// flops a byte where bf16 tensor cores stop waiting on memory), bytes for
// short chunks over long caches.  So the products go to the tensor cores
// and each K/V tile is read once for every query head that shares it.
//
// Per CTA: one (b, kv_head, q-block).  The R query heads of the KV head and
// bq rows of the block are packed head-minor into 16 * NW rows, 16 per warp:
// packed row m is head g*R + m % R, query row row0 + m / R, so a warp's 16
// rows span few positions and its causal frontier is tight.
//  - Q is copied once into shared memory (cp.async).  At hd 64 and 128 it
//    is held for the whole key loop in registers as mma A-fragments
//    (ldmatrix); at hd 256 those would take 64 registers a thread beside
//    O's 128, past the 255 a thread may hold, so each unit's S = Q K^T
//    re-reads the warp's Q fragments from shared memory with ldmatrix, one
//    16-dim slice at a time, and applies each slice to every 16-key chunk
//    of the unit before the next is read.
//  - K/V stream through a ring of STAGES stages of KT keys (64; 32 at hd
//    256, where a 64-key stage takes 67,584 bytes and three of them beside
//    the Q rows of 8 warps would pass the 227 KB a block may hold) with
//    cp.async.cg 16-byte copies; keys past a unit's live count are
//    zero-filled.  Rows
//    are padded by 16 bytes so ldmatrix's eight row addresses fall in eight
//    different bank groups.  The copy of stage i + STAGES - 1 is in flight
//    while stage i is computed; one barrier per stage.
//  - S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate), then the
//    scale, the softcap cap * tanh(s / cap) and the masks (causal on
//    absolute positions, window, live count, valid row), in the order of
//    layers.flash_attention and the plain versions.  A masked score becomes
//    -inf, so its probability is exactly 0.
//  - Online softmax in registers, in the log2 domain: the row max over the
//    4-thread quad with two __shfl_xor_sync, a running max that starts at
//    the finite PA_NEG_INF so alpha = exp2(m_prev - m_new) is never NaN,
//    row sums kept per thread and summed over the quad once at the end.
//  - O += P V with P as two bf16 parts, hi = bf16(P) and lo = bf16(P -
//    hi), each the A-fragments of one product (hi first): hi + lo holds P
//    to about 16 bits, near the f32 P of the TPU kernels (paged_prefill.py
//    :88-89 and prefix_attention.py's _accumulate) and of the plain
//    versions.  P rounded to bf16 alone (one product) moved the paper
//    models' first-token logits by up to 0.34 from the plain versions'
//    after 32 layers at width 4096 on an H100 80GB HBM3 (PERF.md).  V's
//    B-fragments come from ldmatrix.trans, and O accumulates in f32.
//
// A row's bits do not depend on the chunk or q-block it sits in.  Each row
// sees one online-softmax update per *unit* — a table slot's page in the
// paged kernel, a KT-key tile aligned to key 0 in the prefix kernel — so
// the sequence of updates is fixed by absolute key positions alone.  Inside
// an update the row's scores, max, probabilities and sums depend only on
// its own q, the unit's keys and a fixed lane layout.  Work skipped for a
// CTA or a warp (a unit wholly past its rows' causal frontier or before
// every row's window, or a 16-key chunk past the frontier) has every
// probability exactly 0 for each of those rows: m stays, alpha is exactly
// 1, and adding exact zeros leaves l and O bit for bit as they were.  The
// unmasked path for a fully visible unit performs the masked path's
// arithmetic with every mask true.  So the row count per CTA may change
// with Sq without changing any row.  Keys are never split across CTAs: an
// LSE merge present for some chunk lengths and not others would change a
// row's bits between chunk splits.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int MAXW = 8;       // warps per CTA at most
constexpr float LOG2E = 1.4426950408889634f;

template <int HD> struct Tile {
  static constexpr int STRIDE = HD + 8;          // padded row (elements)
  static constexpr int CH = HD / 8;              // 16-byte chunks a row
  static constexpr int KT = HD <= 128 ? 64 : 32; // keys per pipeline stage
  static constexpr int STAGES = 3;               // stages in the K/V ring
  static constexpr int STAGE = 2 * KT * STRIDE;  // K rows, then V rows
  // Q's A-fragments held in registers for the whole key loop, or re-read
  // from shared memory at each unit (hd 256)
  static constexpr bool QREG = HD <= 128;
};

// Dynamic shared memory: the Q rows of nw warps and the K/V ring, then
// `extra` bytes for the caller (at hd 256 and 8 warps: 168,960 bytes
// before `extra`).
template <int HD> inline size_t smem_bytes(int nw, size_t extra) {
  using T = Tile<HD>;
  return ((size_t)16 * nw + (size_t)T::STAGES * 2 * T::KT) * T::STRIDE *
             sizeof(bf16) + extra;
}

// Warps per CTA (*nw): the most (8) unless the grid would then hold fewer
// than two CTAs per SM of the current device; fewer rows per CTA give more
// CTAs for short chunks.  Returns the error of the device query, if any.
inline cudaError_t pick_warps(int B, int KV, int Sq, int R, int* nw) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *nw = MAXW;
  while (*nw > 2) {
    const int bq = 16 * *nw / R;
    if ((long long)B * KV * ((Sq + bq - 1) / bq) >= 2LL * sms) break;
    *nw /= 2;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !fill (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi), so that
// hi + lo holds x to about 16 significant bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// ---------------------------------------------------------------------------
// rows of a CTA, state of a warp
// ---------------------------------------------------------------------------

// Packed rows of one CTA: packed row m is head g*R + m % R and query row
// qi(m) = row0 + m / R, valid iff m < R * bq and qi(m) < ql; query row qi
// sits at absolute position qbase + qi.
struct QRows {
  int R, bq, row0, ql, qbase;
  __device__ int qi(int m) const { return row0 + m / R; }
  __device__ bool live(int m) const { return m < R * bq; }
  __device__ bool valid(int m) const { return live(m) && qi(m) < ql; }
};

// One warp's 16 rows: fragment rows g = lane / 4 and g + 8.
template <int HD> struct Warp {
  // Q A-fragments, one per 16 head dims (QREG), or this lane's ldmatrix
  // address of them in shared memory
  uint32_t q[Tile<HD>::QREG ? HD / 16 : 1][4];
  const bf16* qa;
  float o[HD / 8][4];       // O accumulators, one per 8 head dims
  float m[2], l[2];         // running max (log2 domain); per-thread sums
  int qpos[2];              // absolute positions of rows g, g + 8
  bool ok[2];               // rows g, g + 8 valid
  int lo, hi;               // positions of the warp's valid rows (lo > hi:
                            // none)
};

// cp.async every Q row of the CTA's warps (nrows = 16 * NW) into qs; rows
// that are not live, or past Sq, are zero-filled.
template <int HD>
__device__ __forceinline__ void stage_q(bf16* qs, const bf16* q, Strides st,
                                        int b, int g, int Sq, const QRows& rows,
                                        int nrows, int tid, int nthr) {
  constexpr int S = Tile<HD>::STRIDE, CH = Tile<HD>::CH;
  for (int ci = tid; ci < nrows * CH; ci += nthr) {
    const int m = ci / CH, ch = ci % CH;
    const int qi = rows.qi(m);
    const bool in = rows.live(m) && qi < Sq;
    const bf16* src =
        in ? q + b * st.b + qi * st.s +
                 (long long)(g * rows.R + m % rows.R) * st.h + ch * 8
           : q;
    cp_async16(qs + m * S + ch * 8, src, in);
  }
}

template <int HD>
__device__ __forceinline__ void init_warp(Warp<HD>& w, const QRows& rows,
                                          const bf16* qs, int warp,
                                          int lane) {
  constexpr int S = Tile<HD>::STRIDE;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = 16 * warp + (lane >> 2) + 8 * i;
    w.ok[i] = rows.valid(m);
    w.qpos[i] = rows.qbase + rows.qi(m);
    w.m[i] = PA_NEG_INF;
    w.l[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.f;
  const int m0 = 16 * warp, m1 = min(m0 + 15, rows.R * rows.bq - 1);
  const int first = rows.qi(m0), last = min(rows.qi(m1), rows.ql - 1);
  if (m1 < m0 || first > last) {
    w.lo = 1;
    w.hi = 0;
  } else {
    w.lo = rows.qbase + first;
    w.hi = rows.qbase + last;
  }
  // A-fragments: matrices (rows 0-7 | 8-15) x (dims 0-7 | 8-15) of each
  // 16-dim slice; lane l addresses row l % 16, dims 8 * (l / 16)
  const bf16* qr = qs + (16 * warp + (lane & 15)) * S + (lane >> 4) * 8;
  w.qa = qr;
  if constexpr (Tile<HD>::QREG) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(w.q[kk], qr + kk * 16);
  }
}

// One online-softmax update of the warp's rows over a unit of NKC * 16 keys
// in shared memory (K rows at ks, V rows at vs): the first at absolute
// position kpos0, the first c of them live.  Only the first nkc 16-key
// chunks are computed: the caller has found the rest masked for every row
// of the warp.  MASKED = false is the path for a unit every key of which
// every row of the warp sees.
template <int HD, int NKC, bool MASKED>
__device__ __forceinline__ void update(Warp<HD>& w, const bf16* ks,
                                       const bf16* vs, int kpos0, int c,
                                       int nkc, int window, float cap,
                                       float scale, int lane) {
  constexpr int S = Tile<HD>::STRIDE;
  float s[2 * NKC][4];
#pragma unroll
  for (int j = 0; j < 2 * NKC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // S = Q K^T: B-fragments of two 8-key tiles per ldmatrix; lane l
  // addresses key 8 * (l / 16) + l % 8, dims 8 * ((l / 8) % 2)
  const bf16* kr =
      ks + (((lane >> 4) << 3) + (lane & 7)) * S + ((lane >> 3) & 1) * 8;
  if constexpr (Tile<HD>::QREG) {
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      if (kc < nkc) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t bk[4];
          ldsm_x4(bk, kr + kc * 16 * S + kk * 16);
          mma16816(s[2 * kc], w.q[kk], bk[0], bk[1]);
          mma16816(s[2 * kc + 1], w.q[kk], bk[2], bk[3]);
        }
      }
    }
  } else {
    // one 16-dim slice of Q from shared memory at a time, applied to
    // every chunk; each score still sums its slices in increasing order
#pragma unroll 4
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qf[4];
      ldsm_x4(qf, w.qa + kk * 16);
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        if (kc < nkc) {
          uint32_t bk[4];
          ldsm_x4(bk, kr + kc * 16 * S + kk * 16);
          mma16816(s[2 * kc], qf, bk[0], bk[1]);
          mma16816(s[2 * kc + 1], qf, bk[2], bk[3]);
        }
      }
    }
  }
  // scale, softcap, masks, log2 domain; element e of tile j is row
  // g + 8 * (e / 2), key 8 * j + 2 * (lane % 4) + e % 2
  const int t2 = 2 * (lane & 3);
  float mx[2] = {PA_NEG_INF, PA_NEG_INF};
#pragma unroll
  for (int j = 0; j < 2 * NKC; ++j) {
    if ((j >> 1) < nkc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        x *= LOG2E;
        if (MASKED) {
          const int i = e >> 1, col = j * 8 + t2 + (e & 1);
          const int kpos = kpos0 + col;
          const bool vis = w.ok[i] && col < c && kpos <= w.qpos[i] &&
                           (window <= 0 || kpos > w.qpos[i] - window);
          if (!vis) x = -CUDART_INF_F;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
  float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float mn = fmaxf(w.m[i], mx[i]);
    alpha[i] = exp2f(w.m[i] - mn);
    w.m[i] = mn;
  }
#pragma unroll
  for (int j = 0; j < 2 * NKC; ++j) {
    if ((j >> 1) < nkc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - w.m[e >> 1]);   // -inf -> exactly 0
        s[j][e] = p;
        ps[e >> 1] += p;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) w.l[i] = w.l[i] * alpha[i] + ps[i];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    w.o[n][0] *= alpha[0];
    w.o[n][1] *= alpha[0];
    w.o[n][2] *= alpha[1];
    w.o[n][3] *= alpha[1];
  }
  // O += P V: P's accumulator layout is the A-fragment layout of the
  // 16-key chunk, P as hi + lo bf16 parts (two products, hi first); V's
  // B-fragments for two 8-dim tiles per ldmatrix.trans, lane l addressing
  // key 8 * ((l / 8) % 2) + l % 8, dims 8 * (l / 16)
  const bf16* vr =
      vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    if (kc < nkc) {
      uint32_t a[4], a_lo[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], a[0], a_lo[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], a[1], a_lo[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], a[2], a_lo[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], a[3], a_lo[3]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; nd += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vr + kc * 16 * S + nd * 8);
        mma16816(w.o[nd], a, bv[0], bv[1]);
        mma16816(w.o[nd], a_lo, bv[0], bv[1]);
        mma16816(w.o[nd + 1], a, bv[2], bv[3]);
        mma16816(w.o[nd + 1], a_lo, bv[2], bv[3]);
      }
    }
  }
}

// Write the warp's rows: acc / max(l, 1e-30) for valid rows, exact 0 for
// padding rows; rows that are not live or lie past Sq are not written.
template <int HD>
__device__ __forceinline__ void store(const Warp<HD>& w, bf16* out,
                                      Strides st, int b, int g, int Sq,
                                      const QRows& rows, int warp, int lane) {
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = w.l[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = 16 * warp + (lane >> 2) + 8 * i;
    const int qi = rows.qi(m);
    if (!rows.live(m) || qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* dst = out + b * st.b + qi * st.s +
                (long long)(g * rows.R + m % rows.R) * st.h + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const uint32_t v = w.ok[i] ? pack_bf16(w.o[n][2 * i] * inv,
                                             w.o[n][2 * i + 1] * inv)
                                 : 0u;
      *reinterpret_cast<uint32_t*>(dst + n * 8) = v;
    }
  }
}

// Zero every live row of a CTA none of whose rows is valid.
template <int HD>
__device__ __forceinline__ void store_zeros(bf16* out, Strides st, int b,
                                            int g, int Sq, const QRows& rows,
                                            int tid, int nthr) {
  constexpr int CH = Tile<HD>::CH;
  for (int ci = tid; ci < rows.R * rows.bq * CH; ci += nthr) {
    const int m = ci / CH, ch = ci % CH;
    const int qi = rows.qi(m);
    if (qi >= Sq) continue;
    bf16* dst = out + b * st.b + qi * st.s +
                (long long)(g * rows.R + m % rows.R) * st.h + ch * 8;
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The key loop.  The caller has started and committed the cp.async group of
// Q (stage_q); `ld` supplies the keys:
//   tiles()            number of pipeline stages to stream
//   fetch(t, k, v, tid, nthr)  cp.async stage t's K and V rows (KT each)
//   units(t)           units (online-softmax updates) in stage t
//   unit(t, u, kpos0, c)       unit u's first absolute position and live
//                      count; its rows start at row u * NKC * 16
template <int HD, int NKC, class Loader>
__device__ __forceinline__ void run(const Loader& ld, const QRows& rows,
                                    const bf16* qs, bf16* ring, bf16* out,
                                    Strides ost, int b, int g, int Sq,
                                    int window, float cap, float scale) {
  constexpr int S = Tile<HD>::STRIDE, UNIT = NKC * 16;
  constexpr int KT = Tile<HD>::KT, STAGES = Tile<HD>::STAGES;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int T = ld.tiles();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < T) {
      bf16* kd = ring + st * Tile<HD>::STAGE;
      ld.fetch(st, kd, kd + KT * S, tid, nthr);
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();   // Q has landed
  __syncthreads();
  Warp<HD> w;
  init_warp(w, rows, qs, warp, lane);

  for (int it = 0; it < T; ++it) {
    cp_async_wait<STAGES - 2>();   // stage it has landed
    __syncthreads();               // and every warp is done with it - 1
    const int nxt = it + STAGES - 1;
    if (nxt < T) {
      bf16* kd = ring + (nxt % STAGES) * Tile<HD>::STAGE;
      ld.fetch(nxt, kd, kd + KT * S, tid, nthr);
    }
    cp_async_commit();
    if (w.lo > w.hi) continue;
    const bf16* ks = ring + (it % STAGES) * Tile<HD>::STAGE;
    const bf16* vs = ks + KT * S;
    const int nu = ld.units(it);
    for (int u = 0; u < nu; ++u) {
      int kpos0, c;
      ld.unit(it, u, kpos0, c);
      const int last = kpos0 + c - 1;
      if (c <= 0 || kpos0 > w.hi) continue;                    // causal
      if (window > 0 && last <= w.lo - window) continue;       // window
      const bf16* ku = ks + u * UNIT * S;
      const bf16* vu = vs + u * UNIT * S;
      if (c == UNIT && last <= w.lo &&
          (window <= 0 || kpos0 > w.hi - window)) {
        update<HD, NKC, false>(w, ku, vu, kpos0, c, NKC, window, cap, scale,
                               lane);
      } else {
        const int nkc = (min(last, w.hi) - kpos0) / 16 + 1;
        update<HD, NKC, true>(w, ku, vu, kpos0, c, nkc, window, cap, scale,
                              lane);
      }
    }
  }
  cp_async_wait<0>();
  store(w, out, ost, b, g, Sq, rows, warp, lane);
}

}  // namespace attn
