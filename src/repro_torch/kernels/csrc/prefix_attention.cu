// Prefix-cached dense prefill attention over contiguous [prefix ‖ new] KV.
//
// Replaces the TPU kernel repro/kernels/prefix_attention.py::
// prefix_flash_attention (body _kernel, grid (B, H, nq, nk), block_q =
// block_k = 128).
//
// q holds the Sq new tokens of each sequence; k/v hold Skv = prefix_len +
// Sq keys, the cached prefix followed by the new tokens.  Query row i sits
// at absolute position prefix_len + i and sees keys at positions <= its
// own and, with a window w > 0, only keys at positions > qpos - w.  Order
// of operations as in layers.flash_attention: scale, logit softcap, then
// the masks, online max/sum in f32 (masked probabilities exactly 0), then
// acc / max(l, 1e-30).  Every layout is taken through explicit element
// strides (batch, sequence, head), so the model's (B, S, heads, hd)
// activations are read in place; the last dimension must be contiguous.
//
// Bound on Hopper: operations for long sequences (4 * hd flops per visible
// query-key pair against 2 * hd K/V elements per key), bytes for a short
// chunk after a long prefix.
//
// bf16 (the served model; hd 64, 128 and 256): the tensor-core tile of
// attn_tile.cuh.  One CTA per (b, kv_head, q-block) packs the R query heads
// of the KV head with bq rows of the block, 16 rows per warp and 2-8 warps
// (fewer when the grid is thin), so each K/V tile is read once for all R
// heads (the TPU grid streams it R times).  The loader streams KT-key tiles
// (KT = 64, 32 at hd 256) strided from k0 = a multiple of KT from key 0,
// whatever the block, up to
// the block's causal frontier (min(Skv, last row's position + 1)) and from
// the first tile inside the first row's window; keys past the frontier are
// zero-filled and masked.  Each tile is one online-softmax update, so a
// row's bits do not depend on the block or chunk it sits in (see
// attn_tile.cuh).  A tile every key of which every row of a warp sees takes
// the unmasked path (the predicate of prefix_attention.py:79-81, per warp),
// with the same bits as the masked path.  P enters the P @ V product as
// hi + lo bf16 parts (two products; see attn_tile.cuh).
//
// f32 (hd 64, 128 and 256; the CPU-side checks' dtype, never served on the
// card): a CUDA-core body, 64-key tiles through shared memory with f32
// FMAs, scores one (packed row, key) pair per thread and one thread per row
// for the online softmax; same tiles, skips and fast path.
#include "attn_tile.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA
constexpr int MAXR = 16;    // query heads per KV head
constexpr int BK = 64;      // keys per tile

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// KT-key tiles [kstart + KT t, ...) of one (b, kv_head), cut at kend.
template <int HD> struct DenseKeys {
  static constexpr int KT = attn::Tile<HD>::KT;
  const attn::bf16* k;
  const attn::bf16* v;
  long long ks, vs;             // sequence strides
  int kstart, kend;

  __device__ int tiles() const {
    return kend > kstart ? (kend - kstart + KT - 1) / KT : 0;
  }
  __device__ int units(int) const { return 1; }
  __device__ void unit(int t, int, int& kpos0, int& c) const {
    kpos0 = kstart + t * KT;
    c = min(KT, kend - kpos0);
  }
  __device__ void fetch(int t, attn::bf16* kd, attn::bf16* vd, int tid,
                        int nthr) const {
    constexpr int S = attn::Tile<HD>::STRIDE, CH = attn::Tile<HD>::CH;
    const int k0 = kstart + t * KT, c = min(KT, kend - k0);
    for (int ci = tid; ci < KT * CH; ci += nthr) {
      const int r = ci / CH, ch = ci % CH;
      const bool in = r < c;
      attn::cp_async16(kd + r * S + ch * 8,
                       in ? k + (k0 + r) * ks + ch * 8 : k, in);
      attn::cp_async16(vd + r * S + ch * 8,
                       in ? v + (k0 + r) * vs + ch * 8 : v, in);
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(attn::MAXW * 32) prefix_attention_mma(
    const attn::bf16* __restrict__ q, const attn::bf16* __restrict__ k,
    const attn::bf16* __restrict__ v, attn::bf16* __restrict__ out, int H,
    int KV, int Sq, int Skv, int prefix_len, int window, float cap,
    float scale, int bq, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int S = attn::Tile<HD>::STRIDE;
  const int qb = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int R = H / KV, row0 = qb * bq;
  const attn::QRows rows{R, bq, row0, Sq, prefix_len};
  extern __shared__ __align__(16) unsigned char smem[];
  const int nrows = 16 * (nthr / 32);
  attn::bf16* qsm = reinterpret_cast<attn::bf16*>(smem);
  attn::bf16* ring = qsm + nrows * S;

  attn::stage_q<HD>(qsm, q, qs, b, g, Sq, rows, nrows, tid, nthr);
  attn::cp_async_commit();
  const int qmin = prefix_len + row0;
  const int qmax = prefix_len + min(row0 + bq, Sq) - 1;
  // first tile holding a key inside the first row's window; keys past qmax
  // are masked for every row of the block
  constexpr int KT = attn::Tile<HD>::KT;
  int kstart = 0;
  if (window > 0 && qmin - window + 1 > 0)
    kstart = (qmin - window + 1) / KT * KT;
  const DenseKeys<HD> ld{k + b * ks.b + (long long)g * ks.h,
                         v + b * vs.b + (long long)g * vs.h, ks.s, vs.s,
                         kstart, min(Skv, qmax + 1)};
  attn::run<HD, KT / 16>(ld, rows, qsm, ring, out, os, b, g, Sq, window,
                         cap, scale);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int KV, int Sq, int Skv,
                       int prefix_len, int window, float cap, float scale,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       cudaStream_t stream) {
  const int R = H / KV;
  int nw = 0;
  cudaError_t e = attn::pick_warps(B, KV, Sq, R, &nw);
  if (e != cudaSuccess) return e;
  const int bq = 16 * nw / R;
  const size_t smem = attn::smem_bytes<HD>(nw, 0);
  auto kern = prefix_attention_mma<HD>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + bq - 1) / bq, KV, B);
  kern<<<grid, 32 * nw, smem, stream>>>(
      static_cast<const attn::bf16*>(q), static_cast<const attn::bf16*>(k),
      static_cast<const attn::bf16*>(v), static_cast<attn::bf16*>(out), H,
      KV, Sq, Skv, prefix_len, window, cap, scale, bq, qs, ks, vs, os);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT) prefix_attention_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int H, int KV,
    int Sq, int Skv, int prefix_len, int window, float cap, float scale,
    int bq, Strides qs, Strides ks, Strides vs, Strides os) {
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
  T* q_s = reinterpret_cast<T*>(smem);                   // MMAX x SS
  T* k_s = q_s + MMAX * SS;                              // BK x SS
  T* v_s = k_s + BK * SS;                                // BK x SS
  float* s_s = reinterpret_cast<float*>(v_s + BK * SS);  // MMAX x BK
  float* m_s = s_s + MMAX * BK;
  float* l_s = m_s + MMAX;
  float* a_s = l_s + MMAX;

  // packed query rows: m -> head g*R + m / bq, row row0 + m % bq
  for (int ci = tid; ci < M * CH; ci += NT) {
    const int m = ci / CH, c = ci % CH;
    const int r = m / bq, qi = row0 + m % bq;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < Sq) {
      const T* src = q + b * qs.b + qi * qs.s + (long long)(g * R + r) * qs.h;
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
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int x = 0; x < TD; ++x) acc[i][x] = 0.f;
  const int last = min(row0 + bq, Sq) - 1;   // last valid row of the block
  const int qmin = prefix_len + row0, qmax = prefix_len + last;
  // first tile holding a key inside the first row's window; keys past
  // qmax are masked for every row of the block
  int kstart = 0;
  if (window > 0 && qmin - window + 1 > 0)
    kstart = (qmin - window + 1) / BK * BK;
  const int kend = min(Skv, qmax + 1);
  const int tm = tid / 16, td = tid % 16;
  const T* kb = k + b * ks.b + (long long)g * ks.h;
  const T* vb = v + b * vs.b + (long long)g * vs.h;
  __syncthreads();

  for (int k0 = kstart; k0 < kend; k0 += BK) {
    const int c = min(BK, kend - k0);
    load_rows<T, HD>(k_s, kb + k0 * ks.s, ks.s, c, tid, NT);
    load_rows<T, HD>(v_s, vb + k0 * vs.s, vs.s, c, tid, NT);
    // every key of the tile visible to every row of the block
    const bool full = k0 + c - 1 <= qmin &&
                      (window <= 0 || k0 > qmax - window);
    __syncthreads();

    // scores of every (packed row, key) pair
    for (int e = tid; e < M * c; e += NT) {
      const int m = e / c, p = e % c;
      float s = dot_rows<T, HD>(q_s + m * SS, k_s + p * SS) * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      s_s[m * BK + p] = s;
    }
    __syncthreads();

    // online softmax update, one thread per packed row
    if (tid < M) {
      const int m = tid;
      const int qpos = prefix_len + row0 + m % bq;
      float* row = s_s + m * BK;
      const float m_prev = m_s[m];
      float mx = PA_NEG_INF, sum = 0.f;
      if (full) {
        for (int p = 0; p < c; ++p) mx = fmaxf(mx, row[p]);
        const float m_new = fmaxf(m_prev, mx);
        for (int p = 0; p < c; ++p) {
          const float pr = expf(row[p] - m_new);
          row[p] = pr;
          sum += pr;
        }
        mx = m_new;
      } else {
        const bool row_ok = row0 + m % bq < Sq;
        for (int p = 0; p < c; ++p) {
          const int kpos = k0 + p;
          const bool live = row_ok && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
          if (live) mx = fmaxf(mx, row[p]);
        }
        const float m_new = fmaxf(m_prev, mx);
        for (int p = 0; p < c; ++p) {
          const int kpos = k0 + p;
          const bool live = row_ok && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
          const float pr = live ? expf(row[p] - m_new) : 0.f;
          row[p] = pr;
          sum += pr;
        }
        mx = m_new;
      }
      const float alpha = expf(m_prev - mx);
      l_s[m] = l_s[m] * alpha + sum;
      m_s[m] = mx;
      a_s[m] = alpha;
    }
    __syncthreads();

    // acc[m, d] = acc * alpha + sum_p p[m, p] * v[p, d] on the thread's
    // TM x TD register tile (rows tm*TM.., dims td*TD..)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tm * TM + i;
      const float a = m < M ? a_s[m] : 1.f;
#pragma unroll
      for (int x = 0; x < TD; ++x) acc[i][x] *= a;
    }
    for (int p = 0; p < c; ++p) {
      float vf[TD];
#pragma unroll
      for (int x = 0; x < TD; ++x) vf[x] = to_f(v_s[p * SS + td * TD + x]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tm * TM + i;
        if (m < M) {
          const float pm = s_s[m * BK + p];
#pragma unroll
          for (int x = 0; x < TD; ++x) acc[i][x] = fmaf(pm, vf[x], acc[i][x]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tm * TM + i;
    if (m >= M) continue;
    const int r = m / bq, qi = row0 + m % bq;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[m], 1e-30f);
    T* dst = out + b * os.b + qi * os.s + (long long)(g * R + r) * os.h +
             td * TD;
#pragma unroll
    for (int x = 0; x < TD; ++x) dst[x] = from_f<T>(acc[i][x] * inv);
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int KV, int Sq, int Skv,
                       int prefix_len, int window, float cap, float scale,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       cudaStream_t stream) {
  typedef float T;
  constexpr int SS = Rows<T, HD>::STRIDE;
  constexpr int MMAX = 8192 / HD;
  const int R = H / KV;
  const int bq = MMAX / R;
  const size_t smem = align16((size_t)(MMAX + 2 * BK) * SS * sizeof(T)) +
                      (size_t)(MMAX * BK + 3 * MMAX) * sizeof(float);
  auto kern = prefix_attention_f32<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + bq - 1) / bq, KV, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Skv,
      prefix_len, window, cap, scale, bq, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t prefix_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int Sq, int Skv, int hd, int prefix_len, int window, float cap,
    float scale, int is_bf16, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > MAXR || Sq <= 0 || prefix_len < 0 ||
      Skv != prefix_len + Sq || B <= 0) {
    return cudaErrorInvalidValue;
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
#define PA_ARGS q, k, v, out, B, H, KV, Sq, Skv, prefix_len, window, cap, \
                scale, qs, ks, vs, os, s
  if (is_bf16) {
    if (hd == 64) return launch_mma<64>(PA_ARGS);
    if (hd == 128) return launch_mma<128>(PA_ARGS);
    if (hd == 256) return launch_mma<256>(PA_ARGS);
  } else {
    if (hd == 64) return launch_f32<64>(PA_ARGS);
    if (hd == 128) return launch_f32<128>(PA_ARGS);
    if (hd == 256) return launch_f32<256>(PA_ARGS);
  }
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

// Which body serves a dtype: printed by the card checks.
extern "C" const char* prefix_attention_body(int is_bf16) {
  return is_bf16 ? "tensor cores (mma.sync m16n8k16 bf16, cp.async ring)"
                 : "CUDA cores (f32 FMA)";
}

extern "C" const char* prefix_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
