// Paged decode attention straight from the layer-major serving pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (body _decode_kernel, grid (B, H, n_slots)).
//
// One query token per sequence attends over the pool
// k/v_pages (L, n_pages, page, KV, hd) through run tables: table entry j of
// row b is page tables[b, j] holding counts[b, j] tokens from absolute
// position starts[b, j], beginning at slot 0.  GQA maps head h to KV head
// h / R.  Order of operations as in the TPU kernel: scale, logit softcap,
// then the slot and window masks, online max/sum in f32 with masked
// probabilities exactly 0, then acc / max(l, 1e-30) — a row whose runs are
// all empty gives exact zeros.
//
// Bound on Hopper: bytes.  Each key moves 2 * hd elements of K/V and takes
// 4 * R * hd flops with them (7 flops a byte at R = 7 in bf16), far below
// the ~295 flops a byte where the H100's tensor cores would be the limit.
// At decode sizes the bound (about a microsecond) is below the latency of
// a few dependent memory round trips, so the design spreads the keys over
// the SMs and keeps each CTA's critical path to one round trip for its
// table entries, one for K/V and two for the merge; the products stay on
// CUDA cores in f32.
//
// One launch, grid (KV, B, n_split), 256 threads.  Split s of row b covers
// the fixed table entries [s * E, (s + 1) * E), E = max(1, SPLIT_KEYS /
// page).  SPLIT_KEYS is 128, and 64 for rows above 256 bytes (f32 at hd
// 128, bf16 and f32 at hd 256), where 128 keys of K and V would take more
// shared memory than two CTAs a SM can hold (no ring is needed).  At hd
// 256 a split's K/V rows take 67,584 bytes in bf16 and 133,120 in f32.  The split size never depends on
// B, on n_slots or on a row's length, so a row's bits depend only on its
// own run table: not on the batch it sits in, its neighbours' pages, or
// how many empty entries trail its table.
//  - One thread an entry reads counts, starts and tables, while the query
//    rows load.  Entries with count 0 and entries wholly outside the window
//    are skipped (fully masked, so exact).  A block scan packs the split's
//    live keys in table order.
//  - One copy, one wait each for K and V: cp.async.cg 16-byte copies of
//    every live key's K row, then of its V row (rows padded by 16 bytes),
//    all in flight at once; the scores start when K has landed.
//  - Scores: one key a lane, KEYS lanes a head group, RB / (256 / KEYS)
//    heads a lane, dot products in f32 in index order.  The heads are
//    padded to RB in {1, 2, 4, 8, 16} (zero query rows, never stored) so
//    that the code per head has no branch.  Each head's max and sum come
//    from warp shuffles, its group's warps merged in a fixed order.  P
//    stays f32.
//  - P V: warp w sums the heads w, w + 8; a lane owns hd / 32 dims; keys in
//    packed order, four at a time (V rows past the last key zero-filled).
//  - The split writes its partial (m, l, acc) in f32; a split with nothing
//    live writes m = -1e30, l = 0, acc = 0.
//  - Merge: the CTA that finishes last for (b, kv_head) — a device-scope
//    counter, reset by that CTA for the next launch — reads every split's
//    m, then the partials of the splits of nonzero weight: M = max_s m_s,
//    w_s = exp(m_s - M), out = sum_s w_s acc_s / max(sum_s w_s l_s,
//    1e-30), summed in increasing s.  An empty split's weight is exactly
//    0, so leaving it out changes no bit; a row with one live split gets
//    weight exactly 1; an all-empty row gives exact 0.  Launches that share
//    one counter buffer must not run concurrently.
#include "attn_tile.cuh"

namespace {

constexpr int NT = 256;              // threads a CTA
constexpr int NW = NT / 32;          // warps a CTA
constexpr int MAXR = 16;             // query heads per KV head
constexpr int SPLIT_KEYS = 128;      // keys a split covers ...
constexpr int SPLIT_KEYS_WIDE = 64;  // ... and for rows above 256 bytes

template <typename T, int HD> struct Split {
  static constexpr int KEYS =
      sizeof(T) * HD > 256 ? SPLIT_KEYS_WIDE : SPLIT_KEYS;
  static constexpr int HG = NT / KEYS;    // head groups: a key a lane each
  static constexpr int WPG = KEYS / 32;   // warps a head group
  static constexpr int SS = Rows<T, HD>::STRIDE;
  static constexpr size_t KV_BYTES = 2 * (size_t)KEYS * SS * sizeof(T);
  // splits whose weights, sums and live list the merge holds at once, for
  // every head, in the K/V rows
  static constexpr int MCAP = (int)(KV_BYTES / (3 * MAXR * 4));
  // K rows, V rows, q (f32), P (f32), the warps' max and sum, each key's
  // pool row and position, the warps' scan totals
  static constexpr size_t SMEM =
      KV_BYTES +
      ((size_t)MAXR * HD + (size_t)MAXR * KEYS + 2 * NW * MAXR) * 4 +
      (2 * (size_t)KEYS + NW) * 4;
};

// D consecutive elements of a row as f32, in one load (two for f32 at
// D = 8: hd 256)
template <int D>
__device__ __forceinline__ void load_f(const float* p, float (&f)[D]) {
  if constexpr (D == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z,
      f[4 * i + 3] = v.w;
    }
  }
}
template <int D>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p,
                                       float (&f)[D]) {
  uint32_t w[D / 2];
  if constexpr (D == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (D == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// the same from global memory through L2 only (other SMs' partials)
template <int D>
__device__ __forceinline__ void load_cg(const float* p, float (&f)[D]) {
  if constexpr (D == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    f[0] = v.x, f[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z,
      f[4 * i + 3] = v.w;
    }
  }
}
template <int D>
__device__ __forceinline__ void store_f(float* p, const float (&f)[D]) {
  if constexpr (D == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  }
}

template <typename T, int HD, int RB>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ counts, const int* __restrict__ starts,
    const int* __restrict__ qpos, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counters, int H, int KV,
    int n_pages, int page, int n_slots, int n_split, int layer, int window,
    float cap, float scale) {
  using S = Split<T, HD>;
  constexpr int KEYS = S::KEYS, SS = S::SS, N = Pack<T>::N;
  constexpr int HG = S::HG, WPG = S::WPG, MCAP = S::MCAP;
  constexpr int CH = Rows<T, HD>::CHUNKS, DPL = HD / 32;
  constexpr int RH = (RB + HG - 1) / HG;        // heads a thread scores
  constexpr int RP = RH * HG;                   // heads scored, padded
  constexpr int QI = (RP * CH + NT - 1) / NT;   // q chunks a thread
  constexpr int HW = (RB + NW - 1) / NW;        // heads a warp sums
  constexpr int MB = 32 / DPL;                  // partials a lane loads
  const int g = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int R = H / KV;
  const long parts = (long)gridDim.y * H * n_split;
  float* acc_part = part;                 // (B, H, n_split, HD)
  float* m_part = part + parts * HD;      // (B, H, n_split)
  float* l_part = m_part + parts;         // (B, H, n_split)

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // KEYS x SS
  T* v_s = k_s + KEYS * SS;                              // KEYS x SS
  float* q_s = reinterpret_cast<float*>(v_s + KEYS * SS);  // MAXR x HD
  float* p_s = q_s + MAXR * HD;                          // MAXR x KEYS
  float* wm_s = p_s + MAXR * KEYS;                       // NW x MAXR
  float* wl_s = wm_s + NW * MAXR;                        // NW x MAXR
  int* row_s = reinterpret_cast<int*>(wl_s + NW * MAXR);  // KEYS
  int* pos_s = row_s + KEYS;                             // KEYS
  int* tot_s = pos_s + KEYS;                             // NW
  __shared__ int last_s;

  // the query rows of this KV head (zero from R on) and this split's table
  // entries, one a thread, all loads in flight together
  const long hb = (long)b * H + (long)g * R;   // row b's first head of g
  uint4 qraw[QI];
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int ci = tid + i * NT, r = ci / CH;
    qraw[i] = ci < RP * CH && r < R
                  ? __ldg(reinterpret_cast<const uint4*>(q + (hb + r) * HD) +
                          ci % CH)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  const int qp = qpos[b];
  const int E = max(1, KEYS / page);
  const int e0 = s * E, ne = min(E, n_slots - e0);
  int c = 0, pid = 0, st = 0;
  if (tid < ne) {
    const long j = (long)b * n_slots + e0 + tid;
    c = counts[j];
    st = starts[j];
    pid = tables[j];
  }
  c = max(min(c, page), 0);
  if (c > 0 && window > 0 && st + c - 1 <= qp - window) c = 0;
  // exclusive scan of the live counts: where each entry's keys start
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tot_s[w] = x;
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int ci = tid + i * NT;
    if (ci < RP * CH) {
      float f[N];
      Pack<T>::unpack(qraw[i], f);
      float* dst = q_s + (ci / CH) * HD + (ci % CH) * N;
#pragma unroll
      for (int e = 0; e < N; ++e) dst[e] = f[e];
    }
  }
  __syncthreads();
  int first = x - c, n = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (i < w) first += tot_s[i];
    n += tot_s[i];
  }
  const int row0 = (layer * n_pages + pid) * page;
  for (int p = 0; p < c; ++p) {
    row_s[first + p] = row0 + p;
    pos_s[first + p] = st + p;
  }
  __syncthreads();

  if (n == 0) {
    for (int e = tid; e < R * HD; e += NT) {
      const long idx = (hb + e / HD) * n_split + s;
      acc_part[idx * HD + e % HD] = 0.f;
      if (e % HD == 0) {
        m_part[idx] = PA_NEG_INF;
        l_part[idx] = 0.f;
      }
    }
  } else {
    // every live key's K and V rows in flight at once, in two groups so
    // that the scores start while V is still landing; V rows up to the
    // next multiple of 4 keys zero-filled
    const long rs = (long)KV * HD;
    for (int ci = tid; ci < n * CH; ci += NT) {
      const int k = ci / CH, ch = ci % CH;
      attn::cp_async16(k_s + k * SS + ch * N,
                       kp + (long)row_s[k] * rs + (long)g * HD + ch * N, true);
    }
    attn::cp_async_commit();
    for (int ci = tid; ci < n * CH; ci += NT) {
      const int k = ci / CH, ch = ci % CH;
      attn::cp_async16(v_s + k * SS + ch * N,
                       vp + (long)row_s[k] * rs + (long)g * HD + ch * N, true);
    }
    const int n4 = (n + 3) & ~3;
    for (int ci = n * CH + tid; ci < n4 * CH; ci += NT)
      attn::cp_async16(v_s + (ci / CH) * SS + (ci % CH) * N, vp, false);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();
    __syncthreads();

    // scores: key k for heads hg * RH .. hg * RH + RH - 1
    const int k = tid % KEYS, hg = tid / KEYS;
    const bool live = k < n && (window <= 0 || pos_s[k] > qp - window);
    const float* qg = q_s + hg * RH * HD;
    float sc[RH];
#pragma unroll
    for (int i = 0; i < RH; ++i) sc[i] = 0.f;
    if (k < n) {
      const T* kr = k_s + k * SS;
#pragma unroll 2
      for (int d = 0; d < HD; d += N) {
        float kf[N];
        Pack<T>::unpack(*reinterpret_cast<const uint4*>(kr + d), kf);
#pragma unroll
        for (int i = 0; i < RH; ++i) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qg + i * HD + d);
#pragma unroll
          for (int e = 0; e < N / 4; ++e) {
            const float4 qv = q4[e];
            sc[i] = fmaf(qv.x, kf[4 * e], sc[i]);
            sc[i] = fmaf(qv.y, kf[4 * e + 1], sc[i]);
            sc[i] = fmaf(qv.z, kf[4 * e + 2], sc[i]);
            sc[i] = fmaf(qv.w, kf[4 * e + 3], sc[i]);
          }
        }
      }
    }
    // scale, softcap, mask; each warp's max a head
    float red[RH];
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      float v = sc[i] * scale;
      if (cap > 0.f) v = cap * tanhf(v / cap);
      sc[i] = red[i] = live ? v : PA_NEG_INF;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RH; ++i)
        red[i] = fmaxf(red[i], __shfl_xor_sync(0xffffffffu, red[i], o));
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RH; ++i) wm_s[w * MAXR + i] = red[i];
    }
    __syncthreads();
    // the split's max a head (the group's warps in order), probabilities,
    // warp sums
    const int w0 = hg * WPG;
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      float m = wm_s[w0 * MAXR + i];
#pragma unroll
      for (int v = 1; v < WPG; ++v) m = fmaxf(m, wm_s[(w0 + v) * MAXR + i]);
      const float p = live ? expf(sc[i] - m) : 0.f;
      p_s[(hg * RH + i) * KEYS + k] = p;
      red[i] = p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RH; ++i)
        red[i] += __shfl_xor_sync(0xffffffffu, red[i], o);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RH; ++i) wl_s[w * MAXR + i] = red[i];
    }
    attn::cp_async_wait<0>();
    __syncthreads();

    // acc[r, d] = sum_k p[r, k] v[k, d], keys in packed order
    const T* vcol = v_s + lane * DPL;
#pragma unroll
    for (int j = 0; j < HW; ++j) {
      const int r = w + NW * j;
      if (r >= R) continue;
      const float* pr = p_s + r * KEYS;
      float o[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[i] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < n4; kk += 4) {
        float vf[4][DPL];
#pragma unroll
        for (int u = 0; u < 4; ++u) load_f<DPL>(vcol + (kk + u) * SS, vf[u]);
        const float4 p4 = *reinterpret_cast<const float4*>(pr + kk);
        const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < DPL; ++i) o[i] = fmaf(pu[u], vf[u][i], o[i]);
      }
      const long idx = (hb + r) * n_split + s;
      store_f<DPL>(acc_part + idx * HD + lane * DPL, o);
      if (lane == 0) {
        // head r was scored by group r / RH as its head r % RH
        const int hw0 = (r / RH) * WPG, hi = r % RH;
        float m = wm_s[hw0 * MAXR + hi], l = wl_s[hw0 * MAXR + hi];
#pragma unroll
        for (int v = 1; v < WPG; ++v) {
          m = fmaxf(m, wm_s[(hw0 + v) * MAXR + hi]);
          l += wl_s[(hw0 + v) * MAXR + hi];
        }
        m_part[idx] = m;
        l_part[idx] = l;
      }
    }
  }

  // the last CTA of (b, g) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(counters + b * KV + g, 1) == n_split - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) counters[b * KV + g] = 0;
#pragma unroll
  for (int j = 0; j < HW; ++j) {
    const int r = w + NW * j;
    if (r >= R) continue;
    const long i0 = (hb + r) * n_split;
    float* w_s = reinterpret_cast<float*>(smem) + r * 3 * MCAP;
    float* l_s = w_s + MCAP;
    int* ix_s = reinterpret_cast<int*>(l_s + MCAP);
    // M over every split; the first MCAP splits' m and l kept
    float m = PA_NEG_INF;
    for (int t = lane; t < n_split; t += 32) {
      const float mt = __ldcg(m_part + i0 + t);
      m = fmaxf(m, mt);
      if (t < MCAP) {
        w_s[t] = mt;
        l_s[t] = __ldcg(l_part + i0 + t);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f, a[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) a[i] = 0.f;
    for (int c0 = 0; c0 < n_split; c0 += MCAP) {
      const int cn = min(MCAP, n_split - c0);
      // the weights, and the splits of nonzero weight listed in order: a
      // split of weight 0 (an empty one) would add 0 * acc + l, exactly l,
      // so leaving it out changes no bit
      int nl = 0;
      for (int tb = 0; tb < cn; tb += 32) {
        const int t = tb + lane;
        float wt = 0.f;
        if (t < cn) {
          float mt = w_s[t];
          if (c0 > 0) {
            mt = __ldcg(m_part + i0 + c0 + t);
            l_s[t] = __ldcg(l_part + i0 + c0 + t);
          }
          wt = expf(mt - m);
          w_s[t] = wt;
        }
        const unsigned live = __ballot_sync(0xffffffffu, wt != 0.f);
        if (wt != 0.f) ix_s[nl + __popc(live & ((1u << lane) - 1u))] = t;
        nl += __popc(live);
      }
      __syncwarp();
      // MB partials in flight at once, then summed in increasing split
      for (int u0 = 0; u0 < nl; u0 += MB) {
        float f[MB][DPL];
#pragma unroll
        for (int u = 0; u < MB; ++u) {
          if (u0 + u < nl) {
            load_cg<DPL>(acc_part + (i0 + c0 + ix_s[u0 + u]) * HD +
                             lane * DPL, f[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < MB; ++u) {
          if (u0 + u < nl) {
            const int t = ix_s[u0 + u];
            l = fmaf(w_s[t], l_s[t], l);
#pragma unroll
            for (int i = 0; i < DPL; ++i) a[i] = fmaf(w_s[t], f[u][i], a[i]);
          }
        }
      }
      __syncwarp();
    }
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      out[(hb + r) * HD + lane * DPL + i] = from_f<T>(a[i] / den);
  }
}

template <typename T, int HD, int RB>
cudaError_t launch_rb(const void* q, const void* k, const void* v,
                      const void* tables, const void* counts,
                      const void* starts, const void* qpos, void* out,
                      void* part, void* counters, int B, int H, int KV,
                      int n_pages, int page, int n_slots, int n_split,
                      int layer, int window, float cap, float scale,
                      cudaStream_t stream) {
  using S = Split<T, HD>;
  auto kern = paged_decode_kernel<T, HD, RB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(KV, B, n_split), NT, S::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(counts), static_cast<const int*>(starts),
      static_cast<const int*>(qpos), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), H, KV,
      n_pages, page, n_slots, n_split, layer, window, cap, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* counts, const void* starts,
                   const void* qpos, void* out, void* part, void* counters,
                   int B, int H, int KV, int n_pages, int page, int n_slots,
                   int n_split, int layer, int window, float cap, float scale,
                   cudaStream_t stream) {
  const int E = Split<T, HD>::KEYS / page > 1 ? Split<T, HD>::KEYS / page
                                               : 1;
  if (n_split != (n_slots > 0 ? (n_slots + E - 1) / E : 1) ||
      n_split > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  const int R = H / KV;
#define PA_ARGS q, k, v, tables, counts, starts, qpos, out, part, counters, \
                B, H, KV, n_pages, page, n_slots, n_split, layer, window,   \
                cap, scale, stream
  if (R <= 1) return launch_rb<T, HD, 1>(PA_ARGS);
  if (R <= 2) return launch_rb<T, HD, 2>(PA_ARGS);
  if (R <= 4) return launch_rb<T, HD, 4>(PA_ARGS);
  if (R <= 8) return launch_rb<T, HD, 8>(PA_ARGS);
  return launch_rb<T, HD, 16>(PA_ARGS);
#undef PA_ARGS
}

}  // namespace

extern "C" cudaError_t paged_decode_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* counts, const void* starts, const void* qpos, void* out,
    void* part, void* counters, int B, int H, int KV, int hd, int n_pages,
    int page, int n_slots, int n_split, int layer, int window, float cap,
    float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > MAXR || page <= 0) {
    return cudaErrorInvalidValue;
  }
#define PA_ARGS q, k, v, tables, counts, starts, qpos, out, part, counters, \
                B, H, KV, n_pages, page, n_slots, n_split, layer, window,   \
                cap, scale, s
  if (is_bf16) {
    if (hd == 64) return launch<__nv_bfloat16, 64>(PA_ARGS);
    if (hd == 128) return launch<__nv_bfloat16, 128>(PA_ARGS);
    if (hd == 256) return launch<__nv_bfloat16, 256>(PA_ARGS);
  } else {
    if (hd == 64) return launch<float, 64>(PA_ARGS);
    if (hd == 128) return launch<float, 128>(PA_ARGS);
    if (hd == 256) return launch<float, 256>(PA_ARGS);
  }
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
