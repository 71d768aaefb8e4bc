// Fused residual epilogue for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel mxnet_tpu/ops/residual_epilogue.py:_pallas_fwd
// (its pl.pallas_call over _epilogue_kernel): the tail of a ResNet unit,
//
//   out = relu((x + s) * scale + bias)
//
// over the channels-last (rows, C) view of an activation, rows = N*H*W.
//
//   x, s    (rows, C)   f32 or bf16, dense, row-major (the channels-last
//                       memory of a logical NCHW tensor, or a contiguous
//                       NHWC / (rows, C) tensor)
//   scale   (C,) f32    per-channel affine (inference BatchNorm folded)
//   bias    (C,) f32
//   out     (rows, C)   x's dtype
//
// Math, as the TPU kernel computes it: x and s are widened to fp32 and
// added in fp32, the affine and the ReLU run in fp32, and the result is
// rounded once to the output type.  The multiply and the add are kept
// apart (__fmul_rn, __fadd_rn) so that nvcc does not contract them into
// an FMA: in fp32 the kernel is then bit-identical to the plain version
// (ops/residual_epilogue.py:_plain_fwd).  In bf16 the plain version, a
// mirror of the JAX package's lax twin, rounds x + s to bf16 before the
// affine, so the two differ by up to that rounding times the scale, plus
// one rounding of the output.  The ReLU keeps a NaN (jnp.maximum does).
//
// Bound: one read of x and s and one write of out, 3 * rows * C * itemsize
// bytes, against 3 flops per element: far below the ~295 flop/byte the
// H100 needs to leave the memory bound, so the least time is those bytes
// over 3.35 TB/s (scale and bias add 8 * C bytes).
//
// Design: every thread moves 16 bytes per access (4 fp32 or 8 bf16), and
// neighbouring threads take neighbouring 16-byte vectors, so a warp reads
// 512 contiguous bytes per load.  C % 128 == 0 (the wrapper's gate, the
// TPU kernel's lane rule) keeps each vector inside one row, on
// consecutive channels, and 16-byte aligned; the wrapper checks the
// pointers' alignment.  A grid-stride loop covers rows * C / vec vectors
// with at most blocks_per_sm blocks of `threads` threads per SM.  scale
// and bias (at most a few KB) are read through the read-only cache as
// float4.  The TPU kernel's (block_rows, C) VMEM tiles have no
// counterpart: a row block is only a unit of the TPU's sequential grid.
//
// Schedule: the pair (threads, blocks_per_sm) is the launch schedule the
// autotuner searches (ops/residual_epilogue.py:tune), in place of the
// TPU kernel's tuned block_rows.  threads is 128, 256 or 512, each its
// own instantiation so __launch_bounds__ stays exact; blocks_per_sm
// caps the grid.  Every element is computed by the same expression
// whatever the schedule, so every schedule gives bit-identical output.
// The default is (256, 8).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float epilogue(float x, float s, float sc,
                                          float b) {
  const float t = __fadd_rn(__fmul_rn(__fadd_rn(x, s), sc), b);
  return t < 0.f ? 0.f : t;
}

// fp32: one vector is 4 channels
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
residual_epilogue_f32(const float4* __restrict__ x,
                      const float4* __restrict__ s,
                      const float4* __restrict__ scale,
                      const float4* __restrict__ bias,
                      float4* __restrict__ out, long long nvec, int cvec) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < nvec; i += stride) {
    const int c = (int)(i % cvec);
    const float4 a = x[i];
    const float4 r = s[i];
    const float4 sc = __ldg(scale + c);
    const float4 b = __ldg(bias + c);
    float4 o;
    o.x = epilogue(a.x, r.x, sc.x, b.x);
    o.y = epilogue(a.y, r.y, sc.y, b.y);
    o.z = epilogue(a.z, r.z, sc.z, b.z);
    o.w = epilogue(a.w, r.w, sc.w, b.w);
    out[i] = o;
  }
}

// bf16: one vector (uint4) is 8 channels, as 4 __nv_bfloat162 pairs
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
residual_epilogue_bf16(const uint4* __restrict__ x,
                       const uint4* __restrict__ s,
                       const float4* __restrict__ scale,
                       const float4* __restrict__ bias,
                       uint4* __restrict__ out, long long nvec, int cvec) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < nvec; i += stride) {
    const int c = (int)(i % cvec);
    const uint4 a = x[i];
    const uint4 r = s[i];
    const float4 sc0 = __ldg(scale + 2 * c);
    const float4 sc1 = __ldg(scale + 2 * c + 1);
    const float4 b0 = __ldg(bias + 2 * c);
    const float4 b1 = __ldg(bias + 2 * c + 1);
    const float scv[8] = {sc0.x, sc0.y, sc0.z, sc0.w,
                          sc1.x, sc1.y, sc1.z, sc1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 af = __bfloat1622float2(a2[j]);
      const float2 rf = __bfloat1622float2(r2[j]);
      // round to nearest even, like torch's .to(bfloat16)
      o2[j] = __floats2bfloat162_rn(
          epilogue(af.x, rf.x, scv[2 * j], bv[2 * j]),
          epilogue(af.y, rf.y, scv[2 * j + 1], bv[2 * j + 1]));
    }
    out[i] = o;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;  // the H100 SXM's count; only sizes the grid
    }
  }
  return sms;
}

template <int kThreads>
void launch(int dtype, const void* x, const void* s, const void* scale,
            const void* bias, void* out, long long nvec, int cvec,
            int blocks_per_sm, cudaStream_t st) {
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * blocks_per_sm;
  if (blocks > cap) blocks = cap;
  if (dtype == 1) {
    residual_epilogue_bf16<kThreads><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(s),
        static_cast<const float4*>(scale), static_cast<const float4*>(bias),
        static_cast<uint4*>(out), nvec, cvec);
  } else {
    residual_epilogue_f32<kThreads><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(s),
        static_cast<const float4*>(scale), static_cast<const float4*>(bias),
        static_cast<float4*>(out), nvec, cvec);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows * C elements; C % 128 == 0 and
// every pointer 16-byte aligned (the wrapper checks both).  The schedule:
// threads per block (128, 256 or 512) and the most blocks per SM (>= 1).
// Returns -1 for a schedule outside those (nothing is launched), else
// cudaGetLastError() after the launch (0 on success); the Python wrapper
// raises on anything else.
extern "C" int mxtt_residual_epilogue(int dtype, const void* x, const void* s,
                                      const void* scale, const void* bias,
                                      void* out, long long rows, int C,
                                      int threads, int blocks_per_sm,
                                      void* stream) {
  if (blocks_per_sm < 1 ||
      (threads != 128 && threads != 256 && threads != 512)) {
    return -1;
  }
  if (rows <= 0) return 0;
  const int per_vec = dtype == 1 ? 8 : 4;
  const int cvec = C / per_vec;
  const long long nvec = rows * (long long)cvec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads == 128) {
    launch<128>(dtype, x, s, scale, bias, out, nvec, cvec, blocks_per_sm, st);
  } else if (threads == 256) {
    launch<256>(dtype, x, s, scale, bias, out, nvec, cvec, blocks_per_sm, st);
  } else {
    launch<512>(dtype, x, s, scale, bias, out, nvec, cvec, blocks_per_sm, st);
  }
  return (int)cudaGetLastError();
}
