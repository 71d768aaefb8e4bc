// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py:_pallas_attention
// (its pl.pallas_call): single-query decode attention per (slot b, head h),
// read straight off the KV page pool through the slot's block table.
//
//   q       (B, H, 1, dh)          f32 or bf16, contiguous
//   pool_k  (P, L, H, block, dh)   same dtype, contiguous
//   pool_v  (P, L, H, block, dh)
//   bt      (B, M) int32           page ids of each slot's logical blocks
//   cursor  (B,)   int32           slot b attends over positions [0, cursor[b]]
//   out     (B, H, 1, dh)          q's dtype
//
// Math (the plain version in ops/paged_attention.py:_attend):
//   s_j = (q . k_j) / scale           scale = sqrt(dh) rounded to q's dtype
//   p_j = exp(s_j - max) / sum exp    over j <= cursor[b]
//   out = sum_j p_j v_j
// Positions past the cursor are masked with NEG_INF (-1e30) in the plain
// version; exp(NEG_INF - max) is exactly 0 in fp32, so this kernel leaves
// them out of the loops, which gives the same sums.  Accumulation is fp32;
// the result is stored in q's dtype.
//
// Bound: decode attention does 4*dh flops per live position per head and
// reads 2*dh*itemsize bytes for it — about one flop per byte, far below the
// ~295 flop/byte the H100 needs to leave the memory bound.  The least time
// is the K/V rows the function needs over the memory rate:
//   sum_b (cursor_b + 1) * H * dh * 2 * itemsize
//   + q and out bytes + the live page ids and cursors,   over 3.35 TB/s.
// This design reads each live row once (K in the score pass, V in the
// output pass), never the rest of the last page, and never touches a
// page past the cursor, like the TPU kernel's live_only schedule; the TPU
// kernel's VMEM staging and the zeroing of its (S, dh) value buffer have
// no counterpart here.
//
// Layout: one thread block per (b, h), 128 threads = 4 warps.  A warp
// takes 8 neighbouring positions per step, their loads in flight together;
// its 32 lanes split the head dimension (lane, lane+32, ... — neighbouring
// lanes read neighbouring elements) and reduce each dot product with
// shuffles.  Dynamic shared memory holds the scores (cursor+1 floats, at
// most M*block) and the live page ids, which the block loads from bt once
// before the passes (the TPU kernel's scalar prefetch has no counterpart).
// Offsets into the pool are 64-bit: a page is L*H*block*dh elements, and
// at d_model 2048 x 8 layers a pool of 2^17 tokens (32 slots of 4096)
// already holds 2^31 elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;
constexpr int kPerLane = kMaxDh / 32;
constexpr int kUnroll = 8;  // positions a warp has in flight per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int32_t* __restrict__ bt,
                       const int32_t* __restrict__ cursor,
                       T* __restrict__ out, int H, int M, int block, int dh,
                       long long page_stride, long long layer_offset,
                       float scale) {
  extern __shared__ float smem[];
  float* scores = smem;                                 // [M * block]
  int32_t* pages = reinterpret_cast<int32_t*>(smem + M * block);  // [M]
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][kMaxDh];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // live positions [0, cursor]; a cursor past the table clamps to it
  int n_pos = cursor[b] + 1;
  n_pos = n_pos < 1 ? 1 : (n_pos > M * block ? M * block : n_pos);

  const long long head_offset =
      layer_offset + (long long)h * block * dh;

  // the live part of the slot's block table, read once into shared
  // memory so no position waits on a page-id load
  const int32_t* bt_row = bt + (long long)b * M;
  const int n_pages = (n_pos - 1) / block + 1;
  for (int m = threadIdx.x; m < n_pages; m += kThreads) pages[m] = bt_row[m];
  __syncthreads();

  float qr[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < dh ? to_float(q[(long long)bh * dh + d]) : 0.f;
  }

  // pass 1: scores of the live positions, K read once.  A warp takes
  // kUnroll neighbouring positions per step so that their loads are in
  // flight together; a position past the end is clamped onto the last
  // live row (a harmless re-read) and its score discarded.
  float local_max = -3.0e38f;
  for (int s0 = warp * kUnroll; s0 < n_pos; s0 += kWarps * kUnroll) {
    const T* k[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = min(s0 + u, n_pos - 1);
      const int m = s / block;
      k[u] = pool_k + (long long)pages[m] * page_stride + head_offset +
             (long long)(s - m * block) * dh;
      acc[u] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          acc[u] += qr[j] * to_float(k[u][d]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float sc = warp_sum(acc[u]) / scale;
      if (s0 + u < n_pos) {
        if (lane == 0) scores[s0 + u] = sc;
        local_max = fmaxf(local_max, sc);
      }
    }
  }
  if (lane == 0) red[warp] = local_max;
  __syncthreads();
  float mx = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();  // every thread has read red before it is reused

  // pass 2: unnormalised softmax weights and their sum
  float local_sum = 0.f;
  for (int s = threadIdx.x; s < n_pos; s += kThreads) {
    const float p = expf(scores[s] - mx);
    scores[s] = p;
    local_sum += p;
  }
  local_sum = warp_sum(local_sum);
  if (lane == 0) red[warp] = local_sum;
  __syncthreads();  // also publishes scores[] to every warp
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];

  // pass 3: weighted sum of the live V rows, V read once
  float acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
  for (int s0 = warp * kUnroll; s0 < n_pos; s0 += kWarps * kUnroll) {
    const T* v[kUnroll];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = min(s0 + u, n_pos - 1);
      const int m = s / block;
      v[u] = pool_v + (long long)pages[m] * page_stride + head_offset +
             (long long)(s - m * block) * dh;
      p[u] = s0 + u < n_pos ? scores[s] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[j] += p[u] * to_float(v[u][d]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < dh) part[warp][d] = acc[j];
  }
  __syncthreads();
  const float inv = 1.f / total;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part[w][d];
    out[(long long)bh * dh + d] = from_float<T>(o * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* bt, const void* cursor, void* out, int B,
                   int H, int M, int block, int dh, int L, int layer,
                   float scale, cudaStream_t stream) {
  const size_t smem = (size_t)M * block * sizeof(float) +
                      (size_t)M * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long page_stride = (long long)L * H * block * dh;
  const long long layer_offset = (long long)layer * H * block * dh;
  paged_attention_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(cursor), static_cast<T*>(out), H, M, block,
      dh, page_stride, layer_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int mxtt_paged_attention(int dtype, const void* q,
                                    const void* pool_k, const void* pool_v,
                                    const void* bt, const void* cursor,
                                    void* out, int B, int H, int M, int block,
                                    int dh, int L, int layer, float scale,
                                    void* stream) {
  if (dh < 1 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, pool_k, pool_v, bt, cursor, out, B, H, M,
                              block, dh, L, layer, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, pool_k, pool_v, bt, cursor, out, B,
                                      H, M, block, dh, L, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}
