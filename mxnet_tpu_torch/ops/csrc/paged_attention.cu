// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py:_pallas_attention
// (its pl.pallas_call): single-query decode attention per (slot b, head h),
// read straight off the KV page pool through the slot's block table.
//
//   q       (B, H, 1, dh)          f32 or bf16, contiguous, 16-byte aligned
//   pool_k  (P, L, H, block, dh)   same dtype, contiguous, 16-byte aligned
//   pool_v  (P, L, H, block, dh)
//   bt      (B, M) int32           page ids of each slot's logical blocks
//   cursor  (B,)   int32           slot b attends over positions [0, cursor[b]]
//   part    (B*H, n_split, dh + 2) fp32 workspace from the caller
//   out     (B, H, 1, dh)          q's dtype
//
// Math (the plain version in ops/paged_attention.py:_attend):
//   s_j = (q . k_j) / scale           scale = sqrt(dh) rounded to q's dtype
//   p_j = exp(s_j - max) / sum exp    over j <= cursor[b] (clamped to M*block)
//   out = sum_j p_j v_j
// Positions past the cursor are masked with NEG_INF (-1e30) in the plain
// version; exp(NEG_INF - max) is exactly 0 in fp32, so this kernel leaves
// them out, which gives the same sums.  Accumulation is fp32; the result
// is rounded once to q's dtype.
//
// Bound: decode attention does 4*dh flops per live position per head and
// reads 2*dh*itemsize bytes for it -- about one flop per byte, far below
// the ~295 flop/byte the H100 needs to leave the memory bound.  The least
// time is the K/V rows the function needs over the memory rate:
//   sum_b (cursor_b + 1) * H * dh * 2 * itemsize
//   + q and out bytes + the live page ids and cursors,   over 3.35 TB/s.
// Reaching it takes many bytes in flight on every SM.  One CTA per (slot,
// head) cannot: at the serving shape (B 8, H 16) that is 128 CTAs, and
// the slot with the longest cursor sets the time.  So the sequence is
// split (the "flash-decoding" scheme):
//
// 1. paged_split_kernel, grid (B*H, n_split): CTA (bh, c) takes chunk c
//    of whole pages (chunk_pages pages, ~128 positions; the caller picks
//    it from block alone, so no device value is read on the host).  A
//    chunk past the cursor exits at once.  256 threads; a position's K or
//    V row (dh*itemsize bytes) is read with 16-byte loads by a group of
//    lp lanes (the row's 16-byte vectors rounded up to a power of two,
//    at most 32; 16 lanes at bf16 dh 128, so a warp reads 2 positions per
//    load instruction), each group keeping 4 positions' K and V loads in
//    flight; the group reduces each dot product with shuffles and keeps
//    an online softmax (running max m, sum l, fp32 acc), so K and V are
//    read in one pass and no score is stored.  The groups of a warp and
//    then the 8 warps merge their (m, l, acc) in a fixed order, and the
//    CTA writes its partial (acc[dh], m, l) to the fp32 workspace.  (At
//    the serving shape 256 threads, 4 positions in flight per group and
//    ~128-position chunks were the fastest of 2/4/8 positions, 128/256
//    threads and 32-256 positions in a sweep on the H100.)
// 2. paged_combine_kernel, one CTA per (b, h): merges the live chunks'
//    partials in chunk order and writes out = sum acc e^(m - M) /
//    sum l e^(m - M) in q's dtype.  A second launch rather than a
//    last-arriving-CTA merge: it needs no zeroed counter, no atomics and
//    no fence, and its order is fixed, so the same inputs give the same
//    bits; it costs one more launch, queued back to back on the stream.
//
// Every live K and V row is read once, never the rest of the last page,
// and no page past the cursor is touched, like the TPU kernel's live_only
// schedule; the TPU kernel's VMEM staging and the zeroing of its (S, dh)
// value buffer have no counterpart here.  A CTA reads its chunk's page
// ids into shared memory once (the TPU kernel's scalar prefetch has no
// counterpart).  Offsets into the pool are 64-bit: a page is L*H*block*dh
// elements, and at d_model 2048 x 8 layers a pool of 2^17 tokens (32
// slots of 4096) already holds 2^31 elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;
constexpr int kUnroll = 4;           // positions a lane group has in flight
constexpr int kMaxChunkPages = 16;   // pages per chunk (the caller's choice)
constexpr float kNegInf = -1e30f;

// 16 bytes of T widened to floats: 8 bf16 values or 4 fp32 ones
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's .to()
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// live positions [0, cursor]; a cursor past the table clamps to it
__device__ __forceinline__ int live_positions(int cursor, int cap) {
  const int n = cursor + 1;
  return n < 1 ? 1 : (n > cap ? cap : n);
}

// kNV: 16-byte vectors of a row a lane holds (2 only for fp32 dh > 128)
template <typename T, int kNV>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v,
                   const int32_t* __restrict__ bt,
                   const int32_t* __restrict__ cursor,
                   float* __restrict__ part, int H, int M, int block, int dh,
                   int chunk_pages, long long page_stride,
                   long long layer_offset, float scale) {
  using V = Vec<T>;
  constexpr int kE = kNV * V::kN;   // values of q and acc a lane holds
  __shared__ int32_t pages[kMaxChunkPages];
  __shared__ float sh_m[kWarps], sh_l[kWarps];
  __shared__ float sh_acc[kWarps][kMaxDh];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int chunk = chunk_pages * block;
  const int n_pos = live_positions(cursor[b], M * block);
  const int c0 = blockIdx.y * chunk;
  if (c0 >= n_pos) return;   // past the cursor: the combine never reads it
  const int c_end = min(c0 + chunk, n_pos);

  // the chunk's live page ids, read once
  const int n_pages = (c_end - c0 - 1) / block + 1;
  if ((int)threadIdx.x < n_pages)
    pages[threadIdx.x] =
        bt[(long long)b * M + blockIdx.y * chunk_pages + threadIdx.x];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_vec = dh / V::kN;     // 16-byte vectors in a row
  int lp = 1;                        // lanes per position, a power of two
  while (lp < n_vec && lp < 32) lp <<= 1;
  const int groups = 32 / lp;        // positions per warp load instruction
  const int g = lane / lp;
  const int gl = lane - g * lp;      // holds vectors gl, gl + lp, ...

  float qf[kE];
  const T* q_row = q + (long long)bh * dh;
#pragma unroll
  for (int t = 0; t < kNV; ++t) {
    const int j = gl + lp * t;
    if (j < n_vec) {
      V::widen(load16(q_row + j * V::kN), qf + t * V::kN);
    } else {
#pragma unroll
      for (int e = 0; e < V::kN; ++e) qf[t * V::kN + e] = 0.f;
    }
  }

  float m = kNegInf, l = 0.f, acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  const long long head_offset = layer_offset + (long long)h * block * dh;
  // per step the CTA covers kWarps * groups * kUnroll positions; a warp's
  // u-th load instruction reads `groups` neighbouring positions
  const int step = kWarps * groups * kUnroll;
  for (int p0 = c0 + warp * groups * kUnroll; p0 < c_end; p0 += step) {
    uint4 kr[kUnroll][kNV], vr[kUnroll][kNV];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = p0 + u * groups + g;
      live[u] = pos < c_end;
      // a position past the end re-reads the last live row (harmless)
      const int pl = min(pos, c_end - 1) - c0;
      const int pg = pl / block;
      const long long row = (long long)pages[pg] * page_stride +
                            head_offset + (long long)(pl - pg * block) * dh;
#pragma unroll
      for (int t = 0; t < kNV; ++t) {
        const int j = gl + lp * t;
        if (j < n_vec) {
          kr[u][t] = load16(pool_k + row + j * V::kN);
          vr[u][t] = load16(pool_v + row + j * V::kN);
        } else {
          kr[u][t] = vr[u][t] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    float sc[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int t = 0; t < kNV; ++t) {
        float kf[V::kN];
        V::widen(kr[u][t], kf);
#pragma unroll
        for (int e = 0; e < V::kN; ++e) d = fmaf(qf[t * V::kN + e], kf[e], d);
      }
      for (int o = lp >> 1; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      sc[u] = live[u] ? d / scale : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const float p = expf(sc[u] - mx);
      l += p;
#pragma unroll
      for (int t = 0; t < kNV; ++t) {
        float vf[V::kN];
        V::widen(vr[u][t], vf);
#pragma unroll
        for (int e = 0; e < V::kN; ++e)
          acc[t * V::kN + e] = fmaf(p, vf[e], acc[t * V::kN + e]);
      }
    }
  }

  // merge the warp's groups (lanes lp apart hold the same vectors)
  for (int o = lp; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    const float a = expf(m - mn), c = expf(m2 - mn);
    l = l * a + l2 * c;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], o) * c;
    m = mn;
  }
  if (g == 0) {
#pragma unroll
    for (int t = 0; t < kNV; ++t) {
      const int j = gl + lp * t;
      if (j < n_vec) {
#pragma unroll
        for (int e = 0; e < V::kN; ++e)
          sh_acc[warp][j * V::kN + e] = acc[t * V::kN + e];
      }
    }
    if (gl == 0) {
      sh_m[warp] = m;
      sh_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps and write the chunk's partial: acc[dh], m, l
  float mc = sh_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mc = fmaxf(mc, sh_m[w]);
  float wt[kWarps], lc = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sh_m[w] - mc);
    lc += sh_l[w] * wt[w];
  }
  float* out = part + ((long long)bh * gridDim.y + blockIdx.y) * (dh + 2);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sh_acc[w][d] * wt[w];
    out[d] = a;
  }
  if (threadIdx.x == 0) {
    out[dh] = mc;
    out[dh + 1] = lc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part,
                     const int32_t* __restrict__ cursor, T* __restrict__ out,
                     int H, int M, int block, int dh, int chunk_pages,
                     int n_split) {
  const int bh = blockIdx.x;
  const int n_pos = live_positions(cursor[bh / H], M * block);
  const int n_live = (n_pos - 1) / (chunk_pages * block) + 1;
  const float* p = part + (long long)bh * n_split * (dh + 2);
  float mx = kNegInf;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, p[s * (dh + 2) + dh]);
  constexpr int kCols = kMaxDh / kThreads;
  float acc[kCols], l = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int s = 0; s < n_live; ++s) {   // chunk order: deterministic
    const float* ps = p + s * (dh + 2);
    const float w = expf(ps[dh] - mx);
    l += ps[dh + 1] * w;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = threadIdx.x + c * kThreads;
      if (d < dh) acc[c] += ps[d] * w;
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = threadIdx.x + c * kThreads;
    if (d < dh) out[(long long)bh * dh + d] = from_float<T>(acc[c] / l);
  }
}

template <typename T, int kNV>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* bt, const void* cursor, void* part, void* out,
                   int B, int H, int M, int block, int dh, int L, int layer,
                   int chunk_pages, float scale, cudaStream_t stream) {
  const int n_split = (M + chunk_pages - 1) / chunk_pages;
  const long long page_stride = (long long)L * H * block * dh;
  const long long layer_offset = (long long)layer * H * block * dh;
  paged_split_kernel<T, kNV><<<dim3(B * H, n_split), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(cursor), static_cast<float*>(part), H, M,
      block, dh, chunk_pages, page_stride, layer_offset, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(cursor),
      static_cast<T*>(out), H, M, block, dh, chunk_pages, n_split);
  return cudaGetLastError();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: B*H*ceil(M/chunk_pages)*(dh+2)
// floats of workspace.  Launches the split and the combine kernel and
// returns cudaGetLastError() (0 on success); the Python wrapper raises on
// anything else.
extern "C" int mxtt_paged_attention(int dtype, const void* q,
                                    const void* pool_k, const void* pool_v,
                                    const void* bt, const void* cursor,
                                    void* part, void* out, int B, int H,
                                    int M, int block, int dh, int L,
                                    int layer, int chunk_pages, float scale,
                                    void* stream) {
  if (dh < 8 || dh > kMaxDh || dh % 8 || block < 1 || chunk_pages < 1 ||
      chunk_pages > kMaxChunkPages)
    return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(pool_k) || misaligned(pool_v))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dh > 128
               ? (int)launch<float, 2>(q, pool_k, pool_v, bt, cursor, part,
                                       out, B, H, M, block, dh, L, layer,
                                       chunk_pages, scale, s)
               : (int)launch<float, 1>(q, pool_k, pool_v, bt, cursor, part,
                                       out, B, H, M, block, dh, L, layer,
                                       chunk_pages, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, 1>(q, pool_k, pool_v, bt, cursor, part,
                                         out, B, H, M, block, dh, L, layer,
                                         chunk_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}
