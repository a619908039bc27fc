// Helpers shared by the attention kernels: 16-byte tile loads into shared
// memory, element-type conversions for bf16 and f32, and view strides.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_NEG_INF (-1e30f)

// Element strides of a (batch, sequence, head, hd) view with a contiguous
// last dimension.
struct Strides {
  long long b, s, h;
};

// A 16-byte vector holds N elements of T.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is exact: the bf16 bits are the f32's high half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Padded shared-memory row stride (elements): one extra 16-byte chunk per
// row spreads rows read by neighbouring threads over different banks.
template <typename T, int HD> struct Rows {
  static constexpr int STRIDE = HD + 16 / (int)sizeof(T);
  static constexpr int CHUNKS = HD * (int)sizeof(T) / 16;
};

// Copy `rows` rows of HD elements (global row stride `gstride` elements)
// into shared memory with 16-byte loads; neighbouring threads take
// neighbouring chunks of a row.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long gstride, int rows, int tid,
                                          int nthreads) {
  constexpr int CH = Rows<T, HD>::CHUNKS;
  constexpr int SS = Rows<T, HD>::STRIDE;
  for (int ci = tid; ci < rows * CH; ci += nthreads) {
    const int r = ci / CH, c = ci % CH;
    const uint4* s = reinterpret_cast<const uint4*>(src + (long)r * gstride) + c;
    uint4* d = reinterpret_cast<uint4*>(dst + r * SS) + c;
    *d = __ldg(s);
  }
}

// Dot product of a shared-memory row of T (16-byte aligned) with a row of
// the same type, accumulated in f32 in index order.
template <typename T, int HD>
__device__ __forceinline__ float dot_rows(const T* __restrict__ a,
                                          const T* __restrict__ b) {
  constexpr int N = Pack<T>::N;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += N) {
    float fa[N], fb[N];
    Pack<T>::unpack(*reinterpret_cast<const uint4*>(a + d), fa);
    Pack<T>::unpack(*reinterpret_cast<const uint4*>(b + d), fb);
#pragma unroll
    for (int x = 0; x < N; ++x) s = fmaf(fa[x], fb[x], s);
  }
  return s;
}

static inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
