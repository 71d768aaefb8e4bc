// Flash attention for Hopper (sm_90a), hand-written CUDA C++: the forward,
// dQ and dK/dV kernels of exact blockwise attention.
//
// Replaces the three Pallas TPU kernels of mxnet_tpu/ops/flash_attention.py:
//   forward  <- _fwd_kernel      (:41, launched by _fwd_impl :168)
//   dQ       <- _bwd_dq_kernel   (:86, launched by _bwd_impl :206)
//   dK/dV    <- _bwd_dkv_kernel  (:118, launched by _bwd_impl :224)
//
//   q, k, v, o, do, dq, dk, dv   (B*H, T, D)   f32 or bf16, contiguous
//   lse, delta                   (B*H, T)      f32
//
// Math (the plain versions in ops/flash_attention.py):
//   s    = (q * scale) . k^T,  NEG_INF (-1e30) where causal and key > query
//   fwd:  online softmax over key tiles: m, l = running max and sum,
//         o = sum_k exp(s - m) v / max(l, 1e-20),  lse = m + log(max(l, 1e-20))
//   bwd:  p = exp(s - lse),  dp = do . v^T,  ds = p * (dp - delta) * scale
//         dq = sum_k ds . k,  dk = sum_q ds^T . q,  dv = sum_q p^T . do
// delta = rowsum(o * do) is computed by the caller in fp32, as the JAX
// package computes it outside its kernels.  Outputs are rounded once to
// the input dtype.
//
// Two designs live here.
//
// 1. The CUDA-core kernels (flash_fwd_kernel, flash_bwd_dq_kernel,
//    flash_bwd_dkv_kernel): every fp32 call.  All arithmetic is fp32 on
//    the CUDA cores (67 TFLOP/s peak): each thread computes a 4x4 block of
//    the 64x64 score tile (16 FMAs for every 8 shared-memory reads) and a
//    4x8 block of the output tile; tiles sit in shared memory with an odd
//    row stride (D+1).
//    256 threads per block; thread t owns tile rows 4*(t/16)..+3, score
//    columns t%16 + 16*j (j < 4) and output columns t%16 + 16*j (j < 8, so
//    D <= 128); the 16 threads of a row group reduce with shuffles.
//      fwd:  one block per (bh, 64-query tile); loops over 64-key tiles up
//            to the diagonal when causal (the TPU kernel's num_k_live).
//      dq:   one block per (bh, 64-query tile); the same key loop.
//      dkv:  one block per (bh, 64-key tile); loops over query tiles from
//            the diagonal on (the TPU kernel's q_start).
//    fp32 stays here: the tensor cores would take fp32 as TF32 (about three
//    decimal digits), which the fp32 parity of 1e-5 / 1e-4 does not allow.
//
// 2. The tensor-core kernels for every bf16 call (namespace sm90 below:
//    flash_fwd_bf16_sm90, flash_dq_bf16_sm90 and flash_dkv_bf16_sm90),
//    described there.
//
// Keeping dQ and dK/dV in two kernels, as the TPU does, needs no atomics
// and sums in a fixed order, so every kernel here is deterministic: the
// same inputs give the same bits.  The TPU kernel's sequential grid carried
// nothing between steps either, so blocks are independent.  A ragged last
// tile (T not a multiple of the tile) is masked; the kernels' own tiles do
// not depend on the JAX block sizes, which only gate the shape.  Offsets
// are 64-bit (bh * T * D grows past 2^31 at a batch of 128 of this shape).
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kPLd = kTile + 1;      // row stride of the P / dS tiles
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;    // output columns per thread
constexpr float kNegInf = -1e30f;

// the CUDA-core kernels run fp32 only (bf16 takes the sm90 kernels)
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// max / sum over the 16 lanes of a half-warp (xor offsets below 16 stay
// inside the half)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of a (T, D) matrix into a [64][ld] fp32 tile,
// times mul; rows past T read as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, int D, int ld,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int g = row0 + r;
    dst[r * ld + d] =
        g < n_rows ? to_float(src[(long long)g * D + d]) * mul : 0.f;
  }
}

// the thread's 4x4 block of A . B^T over D for two pairs at once:
// s = A1 . B1^T and t = A2 . B2^T (rows of A from the thread's row group,
// rows of B from its column set)
__device__ __forceinline__ void tile_products(
    float (&s)[4][4], float (&t)[4][4], const float* A1, const float* B1,
    const float* A2, const float* B2, int D, int ld, int ty, int tx,
    bool both) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A1[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B1[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    if (both) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A2[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B2[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t[i][j] = fmaf(a[i], b[j], t[i][j]);
    }
  }
}

// ------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, int D, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                    // [64][ld], q * scale
  float* Ks = Qs + kTile * ld;         // [64][ld]
  float* Vs = Ks + kTile * ld;         // [64][ld]
  float* Ps = Vs + kTile * ld;         // [64][kPLd]

  const int bh = blockIdx.x;
  // the longest causal rows first: the last query tiles have the most keys
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const long long base = (long long)bh * n * D;

  load_tile(Qs, q + base, q0, n, D, ld, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_k = (n + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, qt + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's K, V and P reads are done
    load_tile(Ks, k + base, k0, n, D, ld, 1.f);
    load_tile(Vs, v + base, k0, n, D, ld, 1.f);
    __syncthreads();

    float s[4][4], unused[4][4];
    tile_products(s, unused, Qs, Ks, Qs, Ks, D, ld, ty, tx, false);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        if (kc >= n || (causal && kc > qr)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + group_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P is complete

    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPLd + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= n) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D)
        o[base + (long long)qr * D + d] = from_float<T>(acc[i][cc] / l_safe);
    }
    if (tx == 0) lse[(long long)bh * n + qr] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ dQ
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                    // [64][ld], q * scale
  float* dOs = Qs + kTile * ld;        // [64][ld]
  float* Ks = dOs + kTile * ld;        // [64][ld]
  float* Vs = Ks + kTile * ld;         // [64][ld]
  float* dSs = Vs + kTile * ld;        // [64][kPLd]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const long long base = (long long)bh * n * D;

  load_tile(Qs, q + base, q0, n, D, ld, scale);
  load_tile(dOs, dout + base, q0, n, D, ld, 1.f);
  float lse_r[4], delta_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = min(q0 + ty * 4 + i, n - 1);
    lse_r[i] = lse[(long long)bh * n + qr];
    delta_r[i] = delta[(long long)bh * n + qr];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_k = (n + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, qt + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, k + base, k0, n, D, ld, 1.f);
    load_tile(Vs, v + base, k0, n, D, ld, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products(s, dp, Qs, Ks, dOs, Vs, D, ld, ty, tx, true);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const float sc =
            (kc >= n || (causal && kc > qr)) ? kNegInf : s[i][j];
        const float p = expf(sc - lse_r[i]);
        dSs[(ty * 4 + i) * kPLd + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();  // dS is complete

    for (int c = 0; c < kTile; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kPLd + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float kv = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= n) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) dq[base + (long long)qr * D + d] = from_float<T>(acc[i][cc]);
    }
  }
}

// --------------------------------------------------------------- dK/dV
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n, int D, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;                    // [64][ld]
  float* Vs = Ks + kTile * ld;         // [64][ld]
  float* Qs = Vs + kTile * ld;         // [64][ld], q unscaled (for dK)
  float* dOs = Qs + kTile * ld;        // [64][ld]
  float* Ps = dOs + kTile * ld;        // [64 q][kPLd]
  float* dSs = Ps + kTile * kPLd;      // [64 q][kPLd]
  float* lse_s = dSs + kTile * kPLd;   // [64]
  float* delta_s = lse_s + kTile;      // [64]

  const int bh = blockIdx.x;
  // the longest causal columns first: the first key tiles see most queries
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const long long base = (long long)bh * n * D;

  load_tile(Ks, k + base, k0, n, D, ld, 1.f);
  load_tile(Vs, v + base, k0, n, D, ld, 1.f);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_q = (n + kTile - 1) / kTile;
  for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(Qs, q + base, q0, n, D, ld, 1.f);
    load_tile(dOs, dout + base, q0, n, D, ld, 1.f);
    if (threadIdx.x < kTile) {
      const int qr = min(q0 + (int)threadIdx.x, n - 1);
      lse_s[threadIdx.x] = lse[(long long)bh * n + qr];
      delta_s[threadIdx.x] = delta[(long long)bh * n + qr];
    }
    __syncthreads();

    // rows are queries (ty), columns keys (tx); (q * scale) . k as the
    // TPU kernel forms it
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], a2[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * ld + d] * scale;
        a2[i] = dOs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * ld + d];
        b2[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = ty * 4 + i;
      const int qr = q0 + ql;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tx + 16 * j;
        const int kc = k0 + kl;
        float p = 0.f, ds = 0.f;
        if (qr < n) {
          const float sc =
              (kc >= n || (causal && kc > qr)) ? kNegInf : s[i][j];
          p = expf(sc - lse_s[ql]);
          ds = p * (dp[i][j] - delta_s[ql]) * scale;
        }
        Ps[ql * kPLd + kl] = p;
        dSs[ql * kPLd + kl] = ds;
      }
    }
    __syncthreads();  // P and dS are complete

    // now rows are keys (ty): dV += P^T . dO, dK += dS^T . Q
    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * kPLd + ty * 4 + i];
        ds[i] = dSs[r * kPLd + ty * 4 + i];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float dov = dOs[r * ld + d];
          const float qv = Qs[r * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][cc] = fmaf(p[i], dov, acc_v[i][cc]);
            acc_k[i][cc] = fmaf(ds[i], qv, acc_k[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= n) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        dk[base + (long long)kr * D + d] = from_float<T>(acc_k[i][cc]);
        dv[base + (long long)kr * D + d] = from_float<T>(acc_v[i][cc]);
      }
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

size_t tile_bytes(int D) { return (size_t)kTile * (D + 1) * sizeof(float); }
size_t p_bytes() { return (size_t)kTile * kPLd * sizeof(float); }
size_t fwd_smem(int D) { return 3 * tile_bytes(D) + p_bytes(); }
size_t dq_smem(int D) { return 4 * tile_bytes(D) + p_bytes(); }
size_t dkv_smem(int D) {
  return 4 * tile_bytes(D) + 2 * p_bytes() + 2 * kTile * sizeof(float);
}

bool bad_shape(int BH, int n, int D) {
  return BH < 1 || n < 1 || D < 8 || D > kMaxD || D % 8 != 0 ||
         (n + kTile - 1) / kTile > 65535;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int n, int D, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = prepare(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (n + kTile - 1) / kTile);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), n, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int n, int D, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (n + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int n, int D, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (n + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n, D, scale, causal);
  return cudaGetLastError();
}


// ===================================================================== sm90
// The bf16 forward, dQ and dK/dV on Hopper's tensor cores.
//
// flash_fwd_bf16_sm90 replaces the bf16 route of the forward (the TPU's
// _fwd_kernel, mxnet_tpu/ops/flash_attention.py:41); flash_dq_bf16_sm90
// that of dQ (_bwd_dq_kernel, :86); flash_dkv_bf16_sm90 that of dK/dV
// (_bwd_dkv_kernel, :118).  At the training shape (B 8, H 16, T 1024,
// D 128, causal) the forward is bound by its bytes (q, k, v in, o and lse
// out: 40.22 us at 3.35 TB/s, against 34.8 us for its 2 products at 989
// TFLOP/s), dQ by its operations (3 products over the 525k live (query,
// key) pairs: 52.16 us, against 50.4 us for its bytes) and dK/dV by its
// operations (4 products: 69.55 us).  All three keep the products on the
// tensor cores and the tiles' bytes off the threads:
//
// - Warp specialisation, 384 threads: warpgroup 0 is the producer (one
//   thread issues TMA copies; it gives up registers with setmaxnreg),
//   warpgroups 1 and 2 are consumers that each own 64 rows of the tile and
//   run wgmma.mma_async (m64nNk16, bf16 in, fp32 accumulators in
//   registers).
// - Copies: TMA (cp.async.bulk.tensor, 3-D maps over (B*H, T, D)) in
//   boxes of 64 columns (128 bytes, the 128-byte swizzle the wgmma
//   descriptors read), completing on an mbarrier per stage; a ring of 2
//   stages with full/empty barriers.  Rows past T and columns past D read
//   as zeros, which is also how D pads up to the wgmma depth of 16.
// - Forward: one CTA per (bh, 128-query tile); 128-key stages of K and V.
//   S = Q.K^T with both operands from shared memory, the scale applied to
//   the fp32 S, the online softmax in registers (ex2.approx with log2(e)
//   folded into the scale), then O += P.V
//   with P converted in registers to bf16 A fragments (the accumulator
//   layout of S is the register-A layout of P) and V read MN-major.  Only
//   the diagonal tile and a ragged last tile are masked.
// - dK/dV: one CTA per (bh, 128-key tile), K and V resident; 64-query
//   stages of Q, dO, LSE and delta stream from the diagonal on.  Keys are
//   the rows of every accumulator: S^T = K.Q^T and dP^T = V.dO^T come out
//   in the register-A layout of P^T and dS^T, so dV += P^T.dO and
//   dK += dS^T.Q read dO and Q MN-major from the same stage, with no
//   transposed copy.  The query tiles are summed in a fixed order.
// - dQ: one CTA per (bh, 128-query tile), Q and dO resident (one TMA
//   load), each consumer's 64 rows of LSE and delta read once into
//   registers; 64-key stages of K and V stream up to the diagonal.  Per
//   stage S = Q.K^T and dP = dO.V^T are issued together (all operands
//   K-major) and waited for once; P = ex2(S.scale.log2e - LSE.log2e) and
//   dS = P (dP - delta) scale are packed into bf16 A fragments (masked on
//   the diagonal and ragged tiles only), and dQ += dS.K reads the same K
//   stage MN-major, as the forward reads V; the stage is released after
//   that product.  A consumer holds dQ (D/2 fp32), S and dP (32 each) and
//   dS (16): 64-key stages keep that well inside its 232 registers.  A
//   consumer whose rows all precede a causal tile (or lie past T) skips
//   it.  The key tiles are summed in a fixed order: no atomics.
// - Grids are head-major: the CTAs in flight share their heads' K and V
//   (or Q and dO) in L2 instead of each fetching another head's from HBM;
//   within a head the longest causal tiles run first.
//
// Numerics: the same fp32 S, max, sum and accumulators as the CUDA-core
// kernels, plus two bf16 roundings every tensor-core flash kernel has: P
// (forward and dK/dV) and dS (dQ and dK/dV) are rounded to bf16 as the A
// operand of their products.  LSE, m and l stay fp32.
namespace sm90 {

constexpr int kWarpgroup = 128;
constexpr int kThreads = 3 * kWarpgroup;   // producer + 2 consumers
constexpr int kProducerRegs = 40;          // 128*40 + 256*232 = 64512
constexpr int kConsumerRegs = 232;
constexpr int kChunk = 64;                 // bf16 columns per 128-byte row
constexpr uint32_t kChunkRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------------ TMA
// box (64 columns, rows, 1 head) at (col, row, bh) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int bh,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// A tile of `rows` x kD bf16 as TMA leaves it: kD/64 chunks of
// [rows][64], each row 128 bytes, 16-byte groups XOR-swizzled by row % 8
// (the 128-byte swizzle; tiles are 1024-byte aligned).
// K-major operand (the reduced dimension along the row): 8-row groups
// 1024 bytes apart (stride byte offset), leading offset unused.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);  // 128-byte swizzle
}
// MN-major operand (the output columns along the row, the reduced
// dimension down the rows): 64-column chunks `chunk_bytes` apart (leading
// byte offset), 8-row groups 1024 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t chunk_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(chunk_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// the K-major descriptor of reduction step kk (16 columns) of a tile of
// `rows` rows, starting at row `row0`
__device__ __forceinline__ uint64_t kmajor_step(uint32_t tile, int rows,
                                                int row0, int kk) {
  return desc_kmajor(tile + (kk / 4) * rows * kChunkRowBytes +
                     row0 * kChunkRowBytes + (kk % 4) * 32);
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulators across the asynchronous
// products (their registers are written until wgmma_wait_all)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs),
// B MN-major in shared memory (the transposed-B flag)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs),
// B MN-major in shared memory (the transposed-B flag)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The fp32 accumulator of an m64nN product: thread t of the warpgroup
// (warp w = t/32, lane l) holds rows 16w + l/4 (registers 4j, 4j+1) and
// 16w + l/4 + 8 (4j+2, 4j+3) at columns 8j + 2(l%4) + {0, 1}.  Registers
// 8kk..8kk+7 of a score accumulator, packed to bf16 pairs in that order,
// are the A fragment of reduction step kk of the next product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ------------------------------------------------- products and softmax
// S[64 x N] = A[64 rows from a_row0 of a tile of a_rows] . B[N rows]^T over
// kD, both K-major in shared memory
template <int kD, int N>
__device__ __forceinline__ void gemm_abt(float (&d)[N / 2], uint32_t a_tile,
                                         int a_rows, int a_row0,
                                         uint32_t b_tile, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(d, kmajor_step(a_tile, a_rows, a_row0, kk),
             kmajor_step(b_tile, b_rows, 0, kk), kk > 0);
}
// D[64 x kD] += A[64 x K] . B[K rows x kD]: A as bf16 fragments in
// registers, B MN-major in shared memory (a tile of K rows)
template <int kD, int K>
__device__ __forceinline__ void gemm_ab(float (&d)[kD / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs(d, a[kk], desc_mnmajor(b_tile + kk * 16 * kChunkRowBytes,
                                    K * kChunkRowBytes));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- forward
template <int kD>  // the head dim padded to 64 or 128 (zeros past D)
struct Fwd {
  static constexpr int kM = 128;       // query rows per CTA, 64 a consumer
  static constexpr int kN = 128;       // key rows per stage
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = kM * kD * 2;
  static constexpr uint32_t kKVBytes = kN * kD * 2;  // one K or V stage
  // Q | K[stages] | V[stages] | barriers: Q, full[stages], empty[stages]
  static constexpr uint32_t kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int n, int D, float scale, int causal) {
  using C = Fwd<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + C::kQBytes;
  const uint32_t sV = sK + C::kStages * C::kKVBytes;
  const uint32_t bar_q = sQ + C::kBarOffset;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * C::kStages;

  const int bh = blockIdx.y;   // head-major: see the note above
  // the longest causal rows first: the last query tiles have the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kM;
  int n_k = (n + C::kN - 1) / C::kN;
  if (causal) n_k = min(n_k, (min(q0 + C::kM, n) - 1) / C::kN + 1);
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------ producer: TMA only
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, C::kQBytes);
      for (int c = 0; c < kD / kChunk; ++c)
        tma_load(sQ + c * C::kM * kChunkRowBytes, &tm_q, c * kChunk, q0, bh,
                 bar_q);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % C::kStages;
        mbar_wait(bar_empty + 8 * s, ((i / C::kStages) & 1) ^ 1);
        mbar_arrive_tx(bar_full + 8 * s, 2 * C::kKVBytes);
        const uint32_t k_s = sK + s * C::kKVBytes;
        const uint32_t v_s = sV + s * C::kKVBytes;
        for (int c = 0; c < kD / kChunk; ++c) {
          tma_load(k_s + c * C::kN * kChunkRowBytes, &tm_k, c * kChunk,
                   i * C::kN, bh, bar_full + 8 * s);
          tma_load(v_s + c * C::kN * kChunkRowBytes, &tm_v, c * kChunk,
                   i * C::kN, bh, bar_full + 8 * s);
        }
      }
    }
  } else {
    // ------------------------------- consumers: 64 query rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;
    const int t = threadIdx.x % kWarpgroup;
    const int lane = t % 32;
    const int row0 = q0 + 64 * w + 16 * (t / 32) + lane / 4;
    const int row1 = row0 + 8;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;

    float acc[kD / 2];
    zero(acc);
    // running max (in log2 units) and this thread's share of the sum
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_k; ++i) {
      const int s = i % C::kStages;
      const uint32_t k_s = sK + s * C::kKVBytes;
      const uint32_t v_s = sV + s * C::kKVBytes;
      mbar_wait(bar_full + 8 * s, (i / C::kStages) & 1);

      // S = Q.K^T, both from shared memory
      float sc[C::kN / 2];
      wgmma_fence();
      gemm_abt<kD, C::kN>(sc, sQ, C::kM, 64 * w, k_s, C::kN);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale, mask (diagonal or ragged tile only), online softmax
      const int k0 = i * C::kN;
      const bool mask = k0 + C::kN > n ||
                        (causal && k0 + C::kN - 1 > q0 + 64 * w);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (mask) {
            const int col = k0 + 8 * j + cq + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= n || (causal && col > row)) x = kNegInf;
          }
          sc[4 * j + e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[C::kN / 16][4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j) {
        const float p00 = ex2(sc[4 * j] - mn0);
        const float p01 = ex2(sc[4 * j + 1] - mn0);
        const float p10 = ex2(sc[4 * j + 2] - mn1);
        const float p11 = ex2(sc[4 * j + 3] - mn1);
        ps0 += p00 + p01;
        ps1 += p10 + p11;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }

      // O += P.V: P from registers, V MN-major
      wgmma_fence();
      gemm_ab<kD, C::kN>(acc, pa, v_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

    // O = acc / max(l, 1e-20) rounded once; LSE = m + log(max(l, 1e-20))
    const float ls0 = fmaxf(quad_sum(l0), 1e-20f);
    const float ls1 = fmaxf(quad_sum(l1), 1e-20f);
    const long long base = (long long)bh * n;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= D) continue;
      if (row0 < n)
        *reinterpret_cast<__nv_bfloat162*>(o + (base + row0) * D + col) =
            __floats2bfloat162_rn(acc[4 * j] / ls0, acc[4 * j + 1] / ls0);
      if (row1 < n)
        *reinterpret_cast<__nv_bfloat162*>(o + (base + row1) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / ls1,
                                  acc[4 * j + 3] / ls1);
    }
    if (lane % 4 == 0) {
      if (row0 < n) lse[base + row0] = m0 * kLn2 + logf(ls0);
      if (row1 < n) lse[base + row1] = m1 * kLn2 + logf(ls1);
    }
  }
}

// ------------------------------------------------------------------ dK/dV
template <int kD>
struct Dkv {
  static constexpr int kN = 128;       // key rows per CTA, 64 a consumer
  static constexpr int kM = 64;        // query rows per stage
  static constexpr int kStages = 2;
  static constexpr uint32_t kKVBytes = kN * kD * 2;  // K or V, resident
  static constexpr uint32_t kQBytes = kM * kD * 2;   // one Q or dO stage
  // K | V | Q[stages] | dO[stages] | lse[stages][kM] | delta[stages][kM]
  // | barriers: K/V, full[stages], empty[stages]
  static constexpr uint32_t kStatsOffset = 2 * kKVBytes + 2 * kStages * kQBytes;
  static constexpr uint32_t kBarOffset = kStatsOffset + 2 * kStages * kM * 4;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_bf16_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int n, int D,
                    float scale, int causal) {
  using C = Dkv<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + C::kKVBytes;
  const uint32_t sQ = sV + C::kKVBytes;
  const uint32_t sdO = sQ + C::kStages * C::kQBytes;
  float* lse_s = reinterpret_cast<float*>(smem + C::kStatsOffset);
  float* delta_s = lse_s + C::kStages * C::kM;
  const uint32_t bar_kv = sK + C::kBarOffset;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * C::kStages;

  // head-major grid (the CTAs in flight share their heads' Q and dO in
  // L2); within a head the longest causal columns, the first key tiles,
  // first
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C::kN;
  const int q_begin = causal ? k0 / C::kM : 0;   // the TPU kernel's q_start
  const int n_q = (n + C::kM - 1) / C::kM - q_begin;
  const int wg = threadIdx.x / kWarpgroup;
  const long long base = (long long)bh * n;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);   // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, 2 * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------ producer: warp 0, TMA by lane 0
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(bar_kv, 2 * C::kKVBytes);
        for (int c = 0; c < kD / kChunk; ++c) {
          tma_load(sK + c * C::kN * kChunkRowBytes, &tm_k, c * kChunk, k0,
                   bh, bar_kv);
          tma_load(sV + c * C::kN * kChunkRowBytes, &tm_v, c * kChunk, k0,
                   bh, bar_kv);
        }
      }
      for (int i = 0; i < n_q; ++i) {
        const int s = i % C::kStages;
        const int q0 = (q_begin + i) * C::kM;
        mbar_wait(bar_empty + 8 * s, ((i / C::kStages) & 1) ^ 1);
        for (int r = lane; r < C::kM; r += 32) {   // 0 past T
          const int qr = q0 + r;
          lse_s[s * C::kM + r] = qr < n ? lse[base + qr] : 0.f;
          delta_s[s * C::kM + r] = qr < n ? delta[base + qr] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_tx(bar_full + 8 * s, 2 * C::kQBytes);
          const uint32_t q_s = sQ + s * C::kQBytes;
          const uint32_t do_s = sdO + s * C::kQBytes;
          for (int c = 0; c < kD / kChunk; ++c) {
            tma_load(q_s + c * C::kM * kChunkRowBytes, &tm_q, c * kChunk, q0,
                     bh, bar_full + 8 * s);
            tma_load(do_s + c * C::kM * kChunkRowBytes, &tm_do, c * kChunk,
                     q0, bh, bar_full + 8 * s);
          }
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---------------------------------- consumers: 64 key rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;
    const int t = threadIdx.x % kWarpgroup;
    const int lane = t % 32;
    const int key0 = k0 + 64 * w + 16 * (t / 32) + lane / 4;
    const int key1 = key0 + 8;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // the first query tile with a query at or past this consumer's keys
    const int my_first = causal ? (k0 + 64 * w) / C::kM : 0;

    float acc_dk[kD / 2], acc_dv[kD / 2];
    zero(acc_dk);
    zero(acc_dv);
    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_q; ++i) {
      const int s = i % C::kStages;
      const int q0 = (q_begin + i) * C::kM;
      mbar_wait(bar_full + 8 * s, (i / C::kStages) & 1);
      if (q_begin + i < my_first) {  // every key of mine is past its queries
        mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t q_s = sQ + s * C::kQBytes;
      const uint32_t do_s = sdO + s * C::kQBytes;

      // S^T = K.Q^T and dP^T = V.dO^T, keys as rows
      float st[C::kM / 2], dpt[C::kM / 2];
      wgmma_fence();
      gemm_abt<kD, C::kM>(st, sK, C::kN, 64 * w, q_s, C::kM);
      gemm_abt<kD, C::kM>(dpt, sV, C::kN, 64 * w, do_s, C::kM);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(s - lse), dS^T = P^T (dP^T - delta) scale, as bf16 A
      // fragments; masked (0) on the diagonal tiles and past T only
      const float* lse_t = lse_s + s * C::kM;
      const float* delta_t = delta_s + s * C::kM;
      const bool mask = q0 + C::kM > n ||
                        (causal && k0 + 64 * w + 63 > q0);
      uint32_t pa[C::kM / 16][4], dsa[C::kM / 16][4];
#pragma unroll
      for (int j = 0; j < C::kM / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + cq + (e & 1);
          float pe = ex2(st[4 * j + e] * scale_log2 - lse_t[qc] * kLog2e);
          if (mask) {
            const int key = e < 2 ? key0 : key1;
            if (q0 + qc >= n || (causal && key > q0 + qc)) pe = 0.f;
          }
          p[e] = pe;
          ds[e] = pe * (dpt[4 * j + e] - delta_t[qc]) * scale;
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T.dO and dK += dS^T.Q, dO and Q MN-major from the stage
      wgmma_fence();
      gemm_ab<kD, C::kM>(acc_dv, pa, do_s);
      gemm_ab<kD, C::kM>(acc_dk, dsa, q_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= D) continue;
      if (key0 < n) {
        const long long off = (base + key0) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(acc_dk[4 * j], acc_dk[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(acc_dv[4 * j], acc_dv[4 * j + 1]);
      }
      if (key1 < n) {
        const long long off = (base + key1) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(acc_dk[4 * j + 2], acc_dk[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(acc_dv[4 * j + 2], acc_dv[4 * j + 3]);
      }
    }
  }
}

// --------------------------------------------------------------------- dQ
template <int kD>
struct Dq {
  static constexpr int kM = 128;       // query rows per CTA, 64 a consumer
  static constexpr int kN = 64;        // key rows per stage
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = kM * kD * 2;   // Q or dO, resident
  static constexpr uint32_t kKVBytes = kN * kD * 2;  // one K or V stage
  // Q | dO | K[stages] | V[stages] | barriers: Q/dO, full[stages],
  // empty[stages]
  static constexpr uint32_t kBarOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_bf16_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int n, int D, float scale,
                   int causal) {
  using C = Dq<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + C::kQBytes;
  const uint32_t sK = sdO + C::kQBytes;
  const uint32_t sV = sK + C::kStages * C::kKVBytes;
  const uint32_t bar_q = sQ + C::kBarOffset;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * C::kStages;

  const int bh = blockIdx.y;   // head-major, as the forward
  // the longest causal rows first: the last query tiles have the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kM;
  int n_k = (n + C::kN - 1) / C::kN;
  if (causal) n_k = min(n_k, (min(q0 + C::kM, n) - 1) / C::kN + 1);
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------ producer: TMA only
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, 2 * C::kQBytes);
      for (int c = 0; c < kD / kChunk; ++c) {
        tma_load(sQ + c * C::kM * kChunkRowBytes, &tm_q, c * kChunk, q0, bh,
                 bar_q);
        tma_load(sdO + c * C::kM * kChunkRowBytes, &tm_do, c * kChunk, q0,
                 bh, bar_q);
      }
      for (int i = 0; i < n_k; ++i) {
        const int s = i % C::kStages;
        mbar_wait(bar_empty + 8 * s, ((i / C::kStages) & 1) ^ 1);
        mbar_arrive_tx(bar_full + 8 * s, 2 * C::kKVBytes);
        const uint32_t k_s = sK + s * C::kKVBytes;
        const uint32_t v_s = sV + s * C::kKVBytes;
        for (int c = 0; c < kD / kChunk; ++c) {
          tma_load(k_s + c * C::kN * kChunkRowBytes, &tm_k, c * kChunk,
                   i * C::kN, bh, bar_full + 8 * s);
          tma_load(v_s + c * C::kN * kChunkRowBytes, &tm_v, c * kChunk,
                   i * C::kN, bh, bar_full + 8 * s);
        }
      }
    }
  } else {
    // ------------------------------- consumers: 64 query rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;
    const int t = threadIdx.x % kWarpgroup;
    const int lane = t % 32;
    const int row0 = q0 + 64 * w + 16 * (t / 32) + lane / 4;
    const int row1 = row0 + 8;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // this consumer's key tiles: none when all its rows are past T, up to
    // its own diagonal when causal
    int my_k = q0 + 64 * w >= n ? 0 : n_k;
    if (causal) my_k = min(my_k, (min(q0 + 64 * w + 64, n) - 1) / C::kN + 1);

    // LSE (in log2 units) and delta of the thread's two rows, read once;
    // clamped past T, where Q and dO read as zeros and nothing is stored
    const long long base = (long long)bh * n;
    const float lse0 = lse[base + min(row0, n - 1)] * kLog2e;
    const float lse1 = lse[base + min(row1, n - 1)] * kLog2e;
    const float dl0 = delta[base + min(row0, n - 1)];
    const float dl1 = delta[base + min(row1, n - 1)];

    float acc[kD / 2];
    zero(acc);
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_k; ++i) {
      const int s = i % C::kStages;
      mbar_wait(bar_full + 8 * s, (i / C::kStages) & 1);
      if (i >= my_k) {  // every key of the tile is past this consumer's rows
        mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t k_s = sK + s * C::kKVBytes;
      const uint32_t v_s = sV + s * C::kKVBytes;

      // S = Q.K^T and dP = dO.V^T, all four operands K-major; one wait
      float sc[C::kN / 2], dp[C::kN / 2];
      wgmma_fence();
      gemm_abt<kD, C::kN>(sc, sQ, C::kM, 64 * w, k_s, C::kN);
      gemm_abt<kD, C::kN>(dp, sdO, C::kM, 64 * w, v_s, C::kN);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(s - lse), dS = P (dP - delta) scale as bf16 A fragments;
      // masked (0) on the diagonal tile and past T only
      const int k0 = i * C::kN;
      const bool mask = k0 + C::kN > n ||
                        (causal && k0 + C::kN - 1 > q0 + 64 * w);
      uint32_t dsa[C::kN / 16][4];
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          float p = ex2(sc[4 * j + e] * scale_log2 - (hi ? lse1 : lse0));
          if (mask) {
            const int col = k0 + 8 * j + cq + (e & 1);
            if (col >= n || (causal && col > (hi ? row1 : row0))) p = 0.f;
          }
          ds[e] = p * (dp[4 * j + e] - (hi ? dl1 : dl0)) * scale;
        }
        dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS.K: dS from registers, the same K stage read MN-major
      wgmma_fence();
      gemm_ab<kD, C::kN>(acc, dsa, k_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= D) continue;
      if (row0 < n)
        *reinterpret_cast<__nv_bfloat162*>(dq + (base + row0) * D + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (row1 < n)
        *reinterpret_cast<__nv_bfloat162*>(dq + (base + row1) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver (libcuda), found at run time so
// that the library links nothing beyond the CUDA runtime
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a contiguous (B*H, T, D) bf16 tensor as a 3-D map read in boxes of
// (64 columns, rows, 1 head), 128-byte swizzled; rows past T and columns
// past D read as zeros.  0, a cudaError_t, or minus a CUresult.
int make_map(CUtensorMap* map, const void* ptr, int BH, int n, int D,
             int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(ptr) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {kChunk, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <typename K>
int prepare_sm90(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int BH, int n, int D, float scale, int causal,
               cudaStream_t stream) {
  using C = Fwd<kD>;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = make_map(&mq, q, BH, n, D, C::kM)) ||
      (err = make_map(&mk, k, BH, n, D, C::kN)) ||
      (err = make_map(&mv, v, BH, n, D, C::kN)) ||
      (err = prepare_sm90(flash_fwd_bf16_sm90<kD>, C::kSmem)))
    return err;
  const dim3 grid((n + C::kM - 1) / C::kM, BH);
  flash_fwd_bf16_sm90<kD><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      n, D, scale, causal);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int BH, int n, int D, float scale,
               int causal, cudaStream_t stream) {
  using C = Dkv<kD>;
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = make_map(&mq, q, BH, n, D, C::kM)) ||
      (err = make_map(&mk, k, BH, n, D, C::kN)) ||
      (err = make_map(&mv, v, BH, n, D, C::kN)) ||
      (err = make_map(&mdo, dout, BH, n, D, C::kM)) ||
      (err = prepare_sm90(flash_dkv_bf16_sm90<kD>, C::kSmem)))
    return err;
  const dim3 grid((n + C::kN - 1) / C::kN, BH);
  flash_dkv_bf16_sm90<kD><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, D, scale, causal);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int n,
              int D, float scale, int causal, cudaStream_t stream) {
  using C = Dq<kD>;
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = make_map(&mq, q, BH, n, D, C::kM)) ||
      (err = make_map(&mk, k, BH, n, D, C::kN)) ||
      (err = make_map(&mv, v, BH, n, D, C::kN)) ||
      (err = make_map(&mdo, dout, BH, n, D, C::kM)) ||
      (err = prepare_sm90(flash_dq_bf16_sm90<kD>, C::kSmem)))
    return err;
  const dim3 grid((n + C::kM - 1) / C::kM, BH);
  flash_dq_bf16_sm90<kD><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), n,
      D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all three take the sm90 tensor-core
// kernels in bf16).  Each returns cudaGetLastError() after the
// launch (0 on success), or minus a CUresult where the driver refused a
// TMA map; the Python wrapper raises on anything but 0.
extern "C" int mxtt_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse, int BH,
                              int n, int D, float scale, int causal,
                              void* stream) {
  if (bad_shape(BH, n, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(q, k, v, o, lse, BH, n, D, scale, causal,
                                  s);
  if (dtype == 1)
    return D <= 64 ? sm90::launch_fwd<64>(q, k, v, o, lse, BH, n, D, scale,
                                          causal, s)
                   : sm90::launch_fwd<128>(q, k, v, o, lse, BH, n, D, scale,
                                           causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq, int BH, int n, int D, float scale,
                                 int causal, void* stream) {
  if (bad_shape(BH, n, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, dout, lse, delta, dq, BH, n, D,
                                 scale, causal, s);
  if (dtype == 1)
    return D <= 64 ? sm90::launch_dq<64>(q, k, v, dout, lse, delta, dq, BH,
                                         n, D, scale, causal, s)
                   : sm90::launch_dq<128>(q, k, v, dout, lse, delta, dq, BH,
                                          n, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int BH, int n, int D,
                                  float scale, int causal, void* stream) {
  if (bad_shape(BH, n, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, n,
                                  D, scale, causal, s);
  if (dtype == 1)
    return D <= 64 ? sm90::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv,
                                          BH, n, D, scale, causal, s)
                   : sm90::launch_dkv<128>(q, k, v, dout, lse, delta, dk,
                                           dv, BH, n, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory the launch of a kernel asks for at head dim D
// (kernel: 0 = forward, 1 = dQ, 2 = dK/dV; dtype as above), for build
// reports; -1 for an unknown kernel or dtype.
extern "C" int mxtt_flash_smem_bytes(int kernel, int dtype, int D) {
  if (dtype == 1 && kernel == 0)
    return (int)(D <= 64 ? sm90::Fwd<64>::kSmem : sm90::Fwd<128>::kSmem);
  if (dtype == 1 && kernel == 1)
    return (int)(D <= 64 ? sm90::Dq<64>::kSmem : sm90::Dq<128>::kSmem);
  if (dtype == 1 && kernel == 2)
    return (int)(D <= 64 ? sm90::Dkv<64>::kSmem : sm90::Dkv<128>::kSmem);
  if (dtype != 0 && dtype != 1) return -1;
  if (kernel == 0) return (int)fwd_smem(D);
  if (kernel == 1) return (int)dq_smem(D);
  if (kernel == 2) return (int)dkv_smem(D);
  return -1;
}
