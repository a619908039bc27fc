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
// acc / max(l, 1e-30): padding rows give exact zeros.  q is read and out
// written in place through element strides (batch, sequence, head), so the
// model's (B, Sq, H, hd) activations need no copy either way.
//
// Bound on Hopper: operations for long chunks (4 * hd flops per visible
// query-key pair against 2 * hd K/V elements per key), bytes for short
// chunks over long caches.
//
// bf16 (the served model; hd 64, 128 and 256): the tensor-core tile of
// attn_tile.cuh.  One CTA per (b, kv_head, q-block) packs the R query heads
// of the KV head with bq rows of the block, 16 rows per warp and 2-8 warps
// (fewer when the grid is thin), so each page is read once for all R heads.
// The loader first lists the CTA's table slots, dropping empty entries,
// entries wholly past the block's causal frontier and, with a window,
// entries wholly before every row's window (fully masked, so dropping them
// is exact; the TPU kernel streams and masks all of them).  It then streams
// the listed pages through the cp.async ring, KT / KP pages a stage (KT =
// 64 keys, 32 at hd 256), each page zero-padded to KP = 16 keys (32 for
// pages of 17-32).  Every page
// gets its own online-softmax update, as in the TPU kernel and the plain
// version: the sequence of updates a row sees is fixed by the table alone,
// so a row's bits do not depend on the chunk or q-block it sits in (see
// attn_tile.cuh).  P enters the P @ V product as hi + lo bf16 parts (two
// products).
//
// f32 (hd 64, 128 and 256; the CPU-side checks' dtype, never served on the
// card): a CUDA-core body, one page at a time through shared memory with
// f32 FMAs, scores one (packed row, key) pair per thread and one thread per
// row for the online softmax.
#include "attn_tile.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA of the f32 body
constexpr int MAXR = 16;    // query heads per KV head

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// The CTA's table slots, in table order, as {page id, live count, start}.
template <int HD, int NKC> struct PagedKeys {
  static constexpr int UNIT = 16 * NKC;          // keys a page occupies
  static constexpr int UPT = attn::Tile<HD>::KT / UNIT;   // pages a stage
  const int4* list;
  int n;
  const attn::bf16* k;          // page 0, slot 0 of (layer, kv_head)
  const attn::bf16* v;
  long long page_elems, row;    // elements per page, per slot

  __device__ int tiles() const { return (n + UPT - 1) / UPT; }
  __device__ int units(int t) const { return min(UPT, n - t * UPT); }
  __device__ void unit(int t, int u, int& kpos0, int& c) const {
    const int4 e = list[t * UPT + u];
    kpos0 = e.z;
    c = e.y;
  }
  __device__ void fetch(int t, attn::bf16* kd, attn::bf16* vd, int tid,
                        int nthr) const {
    constexpr int S = attn::Tile<HD>::STRIDE, CH = attn::Tile<HD>::CH;
    const int nu = units(t);
    for (int ci = tid; ci < nu * UNIT * CH; ci += nthr) {
      const int r = ci / CH, ch = ci % CH;
      const int4 e = list[t * UPT + r / UNIT];
      const int slot = r % UNIT;
      const bool in = slot < e.y;
      const long long off = in ? e.x * page_elems + slot * row + ch * 8 : 0;
      attn::cp_async16(kd + r * S + ch * 8, k + off, in);
      attn::cp_async16(vd + r * S + ch * 8, v + off, in);
    }
  }
};

template <int HD, int NKC>
__global__ void __launch_bounds__(attn::MAXW * 32) paged_prefill_mma(
    const attn::bf16* __restrict__ q, const attn::bf16* __restrict__ kp,
    const attn::bf16* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ counts, const int* __restrict__ starts,
    const int* __restrict__ q_start, const int* __restrict__ q_len,
    attn::bf16* __restrict__ out, int H, int KV, int Sq, int n_pages,
    int page, int n_slots, int layer, int window, float cap, float scale,
    int bq, Strides qst, Strides ost) {
  constexpr int S = attn::Tile<HD>::STRIDE;
  const int qb = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int R = H / KV, row0 = qb * bq;
  const int qs0 = q_start[b], ql = min(q_len[b], Sq);
  const attn::QRows rows{R, bq, row0, ql, qs0};
  if (row0 >= ql) {                       // padding rows only
    attn::store_zeros<HD>(out, ost, b, g, Sq, rows, tid, nthr);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int nrows = 16 * (nthr / 32);
  attn::bf16* qsm = reinterpret_cast<attn::bf16*>(smem);
  attn::bf16* ring = qsm + nrows * S;
  int4* list = reinterpret_cast<int4*>(
      ring + attn::Tile<HD>::STAGES * attn::Tile<HD>::STAGE);
  __shared__ int warp_n[attn::MAXW];

  attn::stage_q<HD>(qsm, q, qst, b, g, Sq, rows, nrows, tid, nthr);
  attn::cp_async_commit();

  // list the slots the block can see, in table order (ballot + scan)
  const int qmin = qs0 + row0, qmax = qs0 + min(row0 + bq, ql) - 1;
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5;
  int n = 0;
  for (int j0 = 0; j0 < n_slots; j0 += nthr) {
    const int j = j0 + tid;
    bool keep = false;
    int4 e = make_int4(0, 0, 0, 0);
    if (j < n_slots) {
      const int c = min(counts[b * n_slots + j], page);
      const int st = starts[b * n_slots + j];
      keep = c > 0 && st <= qmax &&
             (window <= 0 || st + c - 1 > qmin - window);
      if (keep) e = make_int4(tables[b * n_slots + j], c, st, 0);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int off = n, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) off += warp_n[w];
      total += warp_n[w];
    }
    if (keep) list[off + __popc(bal & ((1u << lane) - 1u))] = e;
    n += total;
    __syncthreads();
  }

  const long long row = (long long)KV * HD;
  const long long page_elems = (long long)page * row;
  const long long base = (long long)layer * n_pages * page_elems +
                         (long long)g * HD;
  const PagedKeys<HD, NKC> ld{list, n, kp + base, vp + base, page_elems, row};
  attn::run<HD, NKC>(ld, rows, qsm, ring, out, ost, b, g, Sq, window, cap,
                     scale);
}

template <int HD, int NKC>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* tables, const void* counts,
                       const void* starts, const void* q_start,
                       const void* q_len, void* out, int B, int H, int KV,
                       int Sq, int n_pages, int page, int n_slots, int layer,
                       int window, float cap, float scale, Strides qst,
                       Strides ost, cudaStream_t stream) {
  const int R = H / KV;
  int nw = 0;
  cudaError_t e = attn::pick_warps(B, KV, Sq, R, &nw);
  if (e != cudaSuccess) return e;
  const int bq = 16 * nw / R;
  const size_t smem = attn::smem_bytes<HD>(nw, (size_t)n_slots * sizeof(int4));
  auto kern = paged_prefill_mma<HD, NKC>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + bq - 1) / bq, KV, B);
  kern<<<grid, 32 * nw, smem, stream>>>(
      static_cast<const attn::bf16*>(q), static_cast<const attn::bf16*>(k),
      static_cast<const attn::bf16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(counts), static_cast<const int*>(starts),
      static_cast<const int*>(q_start), static_cast<const int*>(q_len),
      static_cast<attn::bf16*>(out), H, KV, Sq, n_pages, page, n_slots, layer,
      window, cap, scale, bq, qst, ost);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT) paged_prefill_f32(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ counts, const int* __restrict__ starts,
    const int* __restrict__ q_start, const int* __restrict__ q_len,
    float* __restrict__ out, int H, int KV, int Sq, int n_pages, int page,
    int n_slots, int layer, int window, float cap, float scale, int bq,
    Strides qst, Strides ost) {
  typedef float T;
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
      const T* src = q + b * qst.b + qi * qst.s +
                     (long long)(g * R + r) * qst.h;
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
        for (int x = 0; x < TD; ++x) vf[x] = v_s[p * SS + td * TD + x];
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
    T* dst = out + b * ost.b + qi * ost.s + (long long)(g * R + r) * ost.h +
             td * TD;
#pragma unroll
    for (int x = 0; x < TD; ++x) dst[x] = acc[k][x] * inv;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* tables, const void* counts,
                       const void* starts, const void* q_start,
                       const void* q_len, void* out, int B, int H, int KV,
                       int Sq, int n_pages, int page, int n_slots, int layer,
                       int window, float cap, float scale, Strides qst,
                       Strides ost, cudaStream_t stream) {
  constexpr int SS = Rows<float, HD>::STRIDE;
  constexpr int MMAX = 8192 / HD;
  const int R = H / KV;
  const int bq = MMAX / R;
  const size_t smem = align16((size_t)(MMAX + 2 * page) * SS * sizeof(float)) +
                      (size_t)(MMAX * page + 3 * MMAX) * sizeof(float);
  auto kern = paged_prefill_f32<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + bq - 1) / bq, KV, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(counts), static_cast<const int*>(starts),
      static_cast<const int*>(q_start), static_cast<const int*>(q_len),
      static_cast<float*>(out), H, KV, Sq, n_pages, page, n_slots, layer,
      window, cap, scale, bq, qst, ost);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t paged_prefill_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* counts, const void* starts, const void* q_start,
    const void* q_len, void* out, int B, int H, int KV, int Sq, int hd,
    int n_pages, int page, int n_slots, int layer, int window, float cap,
    float scale, int is_bf16, long long q_sb, long long q_ss, long long q_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > MAXR || page <= 0 || page > 32 ||
      Sq <= 0 || B <= 0) {
    return cudaErrorInvalidValue;
  }
  const Strides qst{q_sb, q_ss, q_sh}, ost{o_sb, o_ss, o_sh};
#define PA_ARGS q, k, v, tables, counts, starts, q_start, q_len, out, B, H, \
                KV, Sq, n_pages, page, n_slots, layer, window, cap, scale,  \
                qst, ost, s
  if (is_bf16) {
    if (hd == 64)
      return page <= 16 ? launch_mma<64, 1>(PA_ARGS)
                        : launch_mma<64, 2>(PA_ARGS);
    if (hd == 128)
      return page <= 16 ? launch_mma<128, 1>(PA_ARGS)
                        : launch_mma<128, 2>(PA_ARGS);
    if (hd == 256)
      return page <= 16 ? launch_mma<256, 1>(PA_ARGS)
                        : launch_mma<256, 2>(PA_ARGS);
  } else {
    if (hd == 64) return launch_f32<64>(PA_ARGS);
    if (hd == 128) return launch_f32<128>(PA_ARGS);
    if (hd == 256) return launch_f32<256>(PA_ARGS);
  }
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

// Which body serves a dtype: printed by the card checks.
extern "C" const char* paged_prefill_body(int is_bf16) {
  return is_bf16 ? "tensor cores (mma.sync m16n8k16 bf16, cp.async ring)"
                 : "CUDA cores (f32 FMA)";
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
