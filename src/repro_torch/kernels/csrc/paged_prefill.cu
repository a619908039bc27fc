// Paged ragged prefill attention straight from the layer-major serving pool.
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py::
// paged_prefill_attention (body _prefill_kernel, grid (B, H, nq, n_slots)).
//
// A prefill chunk's queries attend over the pool k/v_pages
// (L, n_pages, page, KV, hd) through the run tables of paged decode
// (tables/counts/starts).  Query row i of request b sits at absolute
// position q_start[b] + i and is valid iff i < q_len[b]; it sees keys at
// positions <= its own (causal on absolute positions) and, with a window
// w > 0, only keys at positions > qpos - w.  Scale, then softcap, then the
// masks, online softmax in f32 with masked probabilities exactly 0, then
// acc / max(l, 1e-30): padding rows give exact zeros.
//
// Bound on Hopper: operations for long chunks (4 * hd flops per visible
// query-key pair against 2 * hd K/V elements per key), bytes for short
// ones.  Design: one CTA per (b, kv_head, q-block) packs the R query heads
// that share a KV head with BQ rows of the block — R * BQ <= 8192 / hd
// packed rows, BQ = that limit / R, so any R <= 16 (7 for Qwen2) fills the
// tile without padding the head count — and streams one K/V page at a
// time through shared memory, so each page is read once for all R heads.
// Entries with counts == 0, entries wholly past the block's causal
// frontier, and (with a window) entries wholly before every row's window
// are skipped: fully masked, so skipping leaves the result bit-identical;
// the TPU kernel streams and masks all of them.  Scores and the P @ V
// update run as f32 FMAs on CUDA cores with per-thread register tiles;
// tensor-core mma / wgmma and TMA are the next step.
#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA
constexpr int MAXR = 16;    // query heads per KV head

template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ counts, const int* __restrict__ starts,
    const int* __restrict__ q_start, const int* __restrict__ q_len,
    T* __restrict__ out, int H, int KV, int Sq, int n_pages, int page,
    int n_slots, int layer, int window, float cap, float scale, int bq) {
  constexpr int SS = Rows<T, HD>::STRIDE;
  constexpr int CH = Rows<T, HD>::CHUNKS;
  constexpr int MMAX = 8192 / HD;   // packed query rows per CTA
  constexpr int TM = MMAX / 16;     // rows of a thread's register tile
  constexpr int TD = HD / 16;       // head dims of a thread's register tile
  const int qb = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int R = H / KV;
  const int M = R * bq;             // live packed rows: m -> (m / bq, m % bq)
  const int row0 = qb * bq;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                     // MMAX x SS
  T* k_s = q_s + MMAX * SS;                                // page x SS
  T* v_s = k_s + page * SS;                                // page x SS
  float* s_s = reinterpret_cast<float*>(v_s + page * SS);  // MMAX x page
  float* m_s = s_s + MMAX * page;
  float* l_s = m_s + MMAX;
  float* a_s = l_s + MMAX;

  // packed query rows: m -> head g*R + m / bq, row row0 + m % bq
  for (int ci = tid; ci < M * CH; ci += NT) {
    const int m = ci / CH, c = ci % CH;
    const int r = m / bq, qi = row0 + m % bq;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < Sq) {
      const T* src = q + (((long)b * H + (long)g * R + r) * Sq + qi) * HD;
      val = __ldg(reinterpret_cast<const uint4*>(src) + c);
    }
    reinterpret_cast<uint4*>(q_s + m * SS)[c] = val;
  }
  if (tid < MMAX) {
    m_s[tid] = PA_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[TM][TD];
#pragma unroll
  for (int k = 0; k < TM; ++k)
#pragma unroll
    for (int x = 0; x < TD; ++x) acc[k][x] = 0.f;
  const int qs0 = q_start[b];
  const int ql = min(q_len[b], Sq);
  const int last = min(row0 + bq, ql) - 1;   // last valid row of the block
  const int tm = tid / 16, td = tid % 16;
  const long row_stride = (long)KV * HD;
  __syncthreads();

  if (last >= row0) {                        // uniform over the CTA
    const int qmin = qs0 + row0, qmax = qs0 + last;
    for (int j = 0; j < n_slots; ++j) {
      const int c = min(counts[b * n_slots + j], page);
      if (c <= 0) continue;
      const int st = starts[b * n_slots + j];
      if (st > qmax) continue;                               // causal
      if (window > 0 && st + c - 1 <= qmin - window) continue;  // window
      const int pid = tables[b * n_slots + j];
      const long base =
          ((long)layer * n_pages + pid) * page * row_stride + (long)g * HD;
      load_rows<T, HD>(k_s, kp + base, row_stride, c, tid, NT);
      load_rows<T, HD>(v_s, vp + base, row_stride, c, tid, NT);
      __syncthreads();

      // scores of every (packed row, slot) pair
      for (int e = tid; e < M * c; e += NT) {
        const int m = e / c, p = e % c;
        float s = dot_rows<T, HD>(q_s + m * SS, k_s + p * SS) * scale;
        if (cap > 0.f) s = cap * tanhf(s / cap);
        s_s[m * page + p] = s;
      }
      __syncthreads();

      // online softmax update, one thread per packed row
      if (tid < M) {
        const int m = tid;
        const int qi = row0 + m % bq;
        const int qpos = qs0 + qi;
        const bool row_ok = qi < ql;
        float mx = PA_NEG_INF;
        for (int p = 0; p < c; ++p) {
          const int kpos = st + p;
          const bool live = row_ok && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
          if (live) mx = fmaxf(mx, s_s[m * page + p]);
        }
        const float m_prev = m_s[m];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int p = 0; p < c; ++p) {
          const int kpos = st + p;
          const bool live = row_ok && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
          const float pr = live ? expf(s_s[m * page + p] - m_new) : 0.f;
          s_s[m * page + p] = pr;
          sum += pr;
        }
        const float alpha = expf(m_prev - m_new);
        l_s[m] = l_s[m] * alpha + sum;
        m_s[m] = m_new;
        a_s[m] = alpha;
      }
      __syncthreads();

      // acc[m, d] = acc * alpha + sum_p p[m, p] * v[p, d] on the thread's
      // TM x TD register tile (rows tm*TM.., dims td*TD..)
#pragma unroll
      for (int k = 0; k < TM; ++k) {
        const int m = tm * TM + k;
        const float a = m < M ? a_s[m] : 1.f;
#pragma unroll
        for (int x = 0; x < TD; ++x) acc[k][x] *= a;
      }
      for (int p = 0; p < c; ++p) {
        float vf[TD];
#pragma unroll
        for (int x = 0; x < TD; ++x) vf[x] = to_f(v_s[p * SS + td * TD + x]);
#pragma unroll
        for (int k = 0; k < TM; ++k) {
          const int m = tm * TM + k;
          if (m < M) {
            const float pm = s_s[m * page + p];
#pragma unroll
            for (int x = 0; x < TD; ++x) acc[k][x] = fmaf(pm, vf[x], acc[k][x]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < TM; ++k) {
    const int m = tm * TM + k;
    if (m >= M) continue;
    const int r = m / bq, qi = row0 + m % bq;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[m], 1e-30f);
    T* dst = out + (((long)b * H + (long)g * R + r) * Sq + qi) * HD + td * TD;
#pragma unroll
    for (int x = 0; x < TD; ++x) dst[x] = from_f<T>(acc[k][x] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* counts, const void* starts,
                   const void* q_start, const void* q_len, void* out, int B,
                   int H, int KV, int Sq, int n_pages, int page, int n_slots,
                   int layer, int window, float cap, float scale,
                   cudaStream_t stream) {
  constexpr int SS = Rows<T, HD>::STRIDE;
  constexpr int MMAX = 8192 / HD;
  const int R = H / KV;
  const int bq = MMAX / R;
  const size_t smem = align16((size_t)(MMAX + 2 * page) * SS * sizeof(T)) +
                      (size_t)(MMAX * page + 3 * MMAX) * sizeof(float);
  auto kern = paged_prefill_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + bq - 1) / bq, KV, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(counts), static_cast<const int*>(starts),
      static_cast<const int*>(q_start), static_cast<const int*>(q_len),
      static_cast<T*>(out), H, KV, Sq, n_pages, page, n_slots, layer, window,
      cap, scale, bq);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t paged_prefill_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* counts, const void* starts, const void* q_start,
    const void* q_len, void* out, int B, int H, int KV, int Sq, int hd,
    int n_pages, int page, int n_slots, int layer, int window, float cap,
    float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > MAXR || page <= 0 || Sq <= 0) {
    return cudaErrorInvalidValue;
  }
#define PA_ARGS q, k, v, tables, counts, starts, q_start, q_len, out, B, H, \
                KV, Sq, n_pages, page, n_slots, layer, window, cap, scale, s
  if (is_bf16) {
    if (hd == 64) return launch<__nv_bfloat16, 64>(PA_ARGS);
    if (hd == 128) return launch<__nv_bfloat16, 128>(PA_ARGS);
  } else {
    if (hd == 64) return launch<float, 64>(PA_ARGS);
    if (hd == 128) return launch<float, 128>(PA_ARGS);
  }
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
