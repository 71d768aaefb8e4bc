// Flash attention for Hopper (sm_90a), hand-written CUDA C++: the forward,
// dQ and dK/dV kernels of exact blockwise attention.
//
// Replaces the three Pallas TPU kernels of mxnet_tpu/ops/flash_attention.py:
//   flash_fwd_kernel      <- _fwd_kernel      (launched by _fwd_impl)
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel   (launched by _bwd_impl)
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel  (launched by _bwd_impl)
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
// package computes it outside its kernels.  All arithmetic is fp32 (bf16
// inputs are widened on load); outputs are rounded once to the input dtype.
//
// Bound: causal attention at the training shape (T 1024, D 128) does
// about 2*BH*T^2*D flops in the forward, 3x that/2 in dQ and 2x in dK/dV,
// against 4*BH*T*D*itemsize bytes or so: hundreds of flops per byte, so
// the operations bound it.  These kernels run the products in fp32 on the
// CUDA cores (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
// bf16): right and simple first; wgmma/TMA is later work.  The design
// keeps what bounds it busy: each thread computes a 4x4 block of the
// 64x64 score tile (16 FMAs for every 8 shared-memory reads) and a 4x8
// block of the output tile; tiles sit in shared memory with an odd row
// stride (D+1), so the 16 rows a half-warp reads fall in 16 banks.
//
// Layout: 256 threads per block; thread t owns tile rows 4*(t/16)..+3,
// score columns t%16 + 16*j (j < 4) and output columns t%16 + 16*j
// (j < 8, so D <= 128).  The 16 threads of one row group form half a warp
// and reduce row maxima and sums with shuffles.
//   fwd:  one block per (bh, 64-query tile); loops over 64-key tiles up to
//         the diagonal when causal (the TPU kernel's num_k_live).
//   dq:   one block per (bh, 64-query tile); the same key loop.
//   dkv:  one block per (bh, 64-key tile); loops over query tiles from the
//         diagonal on (the TPU kernel's q_start).  Keeping dQ and dK/dV in
//         two kernels, as the TPU does, needs no atomics and sums in a
//         fixed order, so results are deterministic.
// The TPU kernel's sequential grid carried nothing between steps either,
// so blocks are independent.  A ragged last tile (T % 64 != 0) is
// masked; the kernels' own tiles do not depend on the JAX block sizes,
// which only gate the shape.  Offsets are 64-bit (bh * T * D grows past
// 2^31 at a batch of 128 of this shape).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kPLd = kTile + 1;      // row stride of the P / dS tiles
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;    // output columns per thread
constexpr float kNegInf = -1e30f;

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

bool bad_shape(int BH, int n, int D) {
  return BH < 1 || n < 1 || D < 8 || D > kMaxD || D % 8 != 0 ||
         (n + kTile - 1) / kTile > 65535;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int n, int D, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(D) + p_bytes();
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
  const size_t smem = 4 * tile_bytes(D) + p_bytes();
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
  const size_t smem =
      4 * tile_bytes(D) + 2 * p_bytes() + 2 * kTile * sizeof(float);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// the launch (0 on success); the Python wrapper raises on anything else.
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
    return (int)launch_fwd<__nv_bfloat16>(q, k, v, o, lse, BH, n, D, scale,
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
    return (int)launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH,
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
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                          BH, n, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
