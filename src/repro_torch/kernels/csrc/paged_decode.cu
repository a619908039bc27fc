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
// Bound on Hopper: bytes.  Each token moves 2 * hd elements of K/V and
// does 4 * R * hd flops with them, far below the H100's ~295 flops/byte.
// Design: one CTA per (b, kv_head) serves all R query heads of that KV
// head, so each K/V page is read from device memory once per KV head (the
// TPU grid streams it R times).  Entries with counts == 0, and entries
// wholly outside the sliding window, are skipped: they are fully masked,
// so skipping them leaves the result bit-identical.  Pages arrive in
// shared memory by 16-byte loads.  B * KV CTAs is few for 132 SMs at small
// batch (16 at B=8, KV=2); splitting the slots across CTAs with a
// log-sum-exp merge is the next step.
#include "common.cuh"

namespace {

constexpr int NT = 128;     // threads per CTA
constexpr int MAXR = 16;    // query heads per KV head

template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ counts, const int* __restrict__ starts,
    const int* __restrict__ qpos, T* __restrict__ out, int H, int KV,
    int n_pages, int page, int n_slots, int layer, int window, float cap,
    float scale) {
  constexpr int SS = Rows<T, HD>::STRIDE;
  constexpr int ACC = MAXR * HD / NT;
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int R = H / KV;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                  // MAXR x SS
  T* k_s = q_s + MAXR * SS;                             // page x SS
  T* v_s = k_s + page * SS;                             // page x SS
  float* s_s = reinterpret_cast<float*>(v_s + page * SS);  // MAXR x page
  float* m_s = s_s + MAXR * page;
  float* l_s = m_s + MAXR;
  float* a_s = l_s + MAXR;

  // the R query rows of this KV head: q[b, g*R + r, :]
  load_rows<T, HD>(q_s, q + ((long)b * H + (long)g * R) * HD, HD, R, tid, NT);
  if (tid < MAXR) {
    m_s[tid] = PA_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  const int qp = qpos[b];
  const long row_stride = (long)KV * HD;
  __syncthreads();

  for (int j = 0; j < n_slots; ++j) {
    const int c = min(counts[b * n_slots + j], page);
    if (c <= 0) continue;
    const int st = starts[b * n_slots + j];
    if (window > 0 && st + c - 1 <= qp - window) continue;
    const int pid = tables[b * n_slots + j];
    const long base =
        ((long)layer * n_pages + pid) * page * row_stride + (long)g * HD;
    load_rows<T, HD>(k_s, kp + base, row_stride, c, tid, NT);
    load_rows<T, HD>(v_s, vp + base, row_stride, c, tid, NT);
    __syncthreads();

    // scores: one (head, slot) pair per thread step
    for (int e = tid; e < R * c; e += NT) {
      const int r = e / c, p = e % c;
      float s = dot_rows<T, HD>(q_s + r * SS, k_s + p * SS) * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      s_s[r * page + p] = s;
    }
    __syncthreads();

    // online softmax update, one thread per query head
    if (tid < R) {
      const int r = tid;
      float mx = PA_NEG_INF;
      for (int p = 0; p < c; ++p) {
        const bool live = window <= 0 || st + p > qp - window;
        if (live) mx = fmaxf(mx, s_s[r * page + p]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = 0; p < c; ++p) {
        const bool live = window <= 0 || st + p > qp - window;
        const float pr = live ? expf(s_s[r * page + p] - m_new) : 0.f;
        s_s[r * page + p] = pr;
        sum += pr;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    // acc[r, d] = acc * alpha + sum_p p[r, p] * v[p, d]
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = i * NT + tid;
      if (e < R * HD) {
        const int r = e / HD, d = e % HD;
        float a = acc[i] * a_s[r];
        for (int p = 0; p < c; ++p)
          a = fmaf(s_s[r * page + p], to_f(v_s[p * SS + d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = i * NT + tid;
    if (e < R * HD) {
      const int r = e / HD, d = e % HD;
      out[((long)b * H + (long)g * R + r) * HD + d] =
          from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* counts, const void* starts,
                   const void* qpos, void* out, int B, int H, int KV,
                   int n_pages, int page, int n_slots, int layer, int window,
                   float cap, float scale, cudaStream_t stream) {
  constexpr int SS = Rows<T, HD>::STRIDE;
  const size_t smem = align16((size_t)(MAXR + 2 * page) * SS * sizeof(T)) +
                      (size_t)(MAXR * page + 3 * MAXR) * sizeof(float);
  auto kern = paged_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KV, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(counts), static_cast<const int*>(starts),
      static_cast<const int*>(qpos), static_cast<T*>(out), H, KV, n_pages,
      page, n_slots, layer, window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t paged_decode_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* counts, const void* starts, const void* qpos, void* out,
    int B, int H, int KV, int hd, int n_pages, int page, int n_slots,
    int layer, int window, float cap, float scale, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > MAXR || page <= 0) {
    return cudaErrorInvalidValue;
  }
#define PA_ARGS q, k, v, tables, counts, starts, qpos, out, B, H, KV, n_pages, \
                page, n_slots, layer, window, cap, scale, s
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

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
