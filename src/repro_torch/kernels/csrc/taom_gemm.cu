// Chunked TAOM-array GEMM with the BPCA / per-chunk-ADC accumulation
// policies, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.taom_gemm.taom_gemm_quantized
// (bodies _kernel_analog_carry and _kernel_chunk_adc).  Inputs are
// integer-valued float32 operands xq (M, K) and wq (K, D), row-major, and
// pre-sampled standard-normal noise: (M, D) for analog carry, (C, M, D) for
// chunk-ADC, C = ceil(K / N) — or a null pointer when noise is off, and
// then the noise term is left out.  Output: (M, D) float32 in integer units.
//
//   analog carry (HEANA, *_bpca): acc = sum_c psum_c, in chunk order;
//       v = acc + coef * noise[m, d]          (coef = f32(sigma * sqrt(C)))
//       out = adc(v)                          (one ADC per output)
//   chunk-ADC (AMW, MAW): out = sum_c adc(psum_c + coef * noise[c, m, d])
//                                             (coef = f32(sigma))
//   adc(v) = clamp(rint(v * inv_step), -hi, hi) * step
//
// Bound on this card: memory.  At the main path's shapes (K <= 144,
// D <= 64) a GEMM does 2*K*D flops for every 4*(K + D*(1 or C) + D) bytes
// of its rows, far below the card's flop-per-byte balance, so the least
// time is bytes / bandwidth with bytes = 4*(M*K + K*D + M*D*(1|C) + M*D),
// the noise term M*D*(1|C) counted only when noise is on.
// What the design does about it: one thread block owns an output tile as
// wide as D (up to 64 columns), so every row of xq is read from device
// memory once; the chunk loop runs inside the block and the BPCA
// accumulator stays in registers, so no psum ever goes back to memory; the
// ragged M, D and K edges are masked in the loads instead of padding the
// operands in memory.
//
// Numerics: every rounding of the reference is kept as a separate IEEE
// float operation (__fmul_rn / __fadd_rn, rintf = round half to even, and
// the file is built with --fmad=false), so the result equals the plain
// PyTorch version bit for bit wherever the integer psums stay below 2^24.
// Inside a chunk the products are accumulated with fmaf: integer products
// and sums below 2^24 are exact in any order and with or without fusion.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 16;     // K-indices staged in shared memory per step
constexpr int kColsPerThread = 4;
constexpr int kRowsPerThread = 2;

__device__ __forceinline__ float adc_round(float v, float inv_step,
                                          float step, float hi) {
  float q = rintf(__fmul_rn(v, inv_step));
  q = fminf(fmaxf(q, -hi), hi);
  return __fmul_rn(q, step);
}

// One block computes a (BM x BD) output tile; thread (ty, tx) owns rows
// ty*TM .. ty*TM+TM-1 and columns tx*4 .. tx*4+3 of it.
template <int BD>
__global__ void __launch_bounds__(kThreads)
taom_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ noise, float* __restrict__ out,
                 int m, int k, int d, int n, int n_chunks, int chunk_adc,
                 float coef, float inv_step, float step, float hi) {
  constexpr int TM = kRowsPerThread;
  constexpr int TX = BD / kColsPerThread;
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * TM;
  // +4 keeps the transposed stores of xq from hitting one bank.
  __shared__ float xs[kTileK][BM + 4];
  __shared__ float ws[kTileK][BD];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int d0 = blockIdx.y * BD;

  float acc[TM][kColsPerThread];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    const int cs = c * n;
    const int ce = min(cs + n, k);
    float ps[TM][kColsPerThread];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) ps[i][j] = 0.0f;

    for (int k0 = cs; k0 < ce; k0 += kTileK) {
      for (int e = tid; e < BM * kTileK; e += kThreads) {
        const int r = e / kTileK;
        const int kk = e % kTileK;
        const long long gm = m0 + r;
        const int gk = k0 + kk;
        xs[kk][r] = (gm < m && gk < ce) ? x[gm * k + gk] : 0.0f;
      }
      for (int e = tid; e < BD * kTileK; e += kThreads) {
        const int kk = e / BD;
        const int col = e % BD;
        const int gk = k0 + kk;
        const int gd = d0 + col;
        ws[kk][col] = (gk < ce && gd < d)
                          ? w[static_cast<long long>(gk) * d + gd] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        float a[TM];
        float b[kColsPerThread];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          b[j] = ws[kk][tx * kColsPerThread + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            ps[i][j] = fmaf(a[i], b[j], ps[i][j]);
      }
      __syncthreads();
    }

    if (chunk_adc) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long gm = m0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int gd = d0 + tx * kColsPerThread + j;
          float v = ps[i][j];
          if (noise != nullptr && gm < m && gd < d) {
            const float z =
                noise[(static_cast<long long>(c) * m + gm) * d + gd];
            v = __fadd_rn(v, __fmul_rn(coef, z));
          }
          acc[i][j] = __fadd_rn(acc[i][j], adc_round(v, inv_step, step, hi));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], ps[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int gd = d0 + tx * kColsPerThread + j;
      if (gd >= d) continue;
      const long long o = gm * d + gd;
      float v = acc[i][j];
      if (!chunk_adc) {
        if (noise != nullptr) v = __fadd_rn(v, __fmul_rn(coef, noise[o]));
        v = adc_round(v, inv_step, step, hi);
      }
      out[o] = v;
    }
  }
}

template <int BD>
void launch(const float* x, const float* w, const float* noise, float* out,
            int m, int k, int d, int n, int n_chunks, int chunk_adc,
            float coef, float inv_step, float step, float hi,
            cudaStream_t stream) {
  constexpr int BM = (kThreads / (BD / kColsPerThread)) * kRowsPerThread;
  dim3 grid((m + BM - 1) / BM, (d + BD - 1) / BD);
  taom_gemm_kernel<BD><<<grid, kThreads, 0, stream>>>(
      x, w, noise, out, m, k, d, n, n_chunks, chunk_adc, coef, inv_step,
      step, hi);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  tile_d is the output tile's
// width in columns (8, 16, 32 or 64); the tile's height is 2048 / tile_d
// rows (256 threads, each 2 rows x 4 columns).  noise may be null (noise
// off).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int taom_gemm_f32(const float* x, const float* w,
                             const float* noise, float* out, int m, int k,
                             int d, int n, int n_chunks, int chunk_adc,
                             float coef, float inv_step, float step,
                             float hi, int tile_d, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (tile_d) {
    case 8:
      launch<8>(x, w, noise, out, m, k, d, n, n_chunks, chunk_adc, coef,
                inv_step, step, hi, stream);
      break;
    case 16:
      launch<16>(x, w, noise, out, m, k, d, n, n_chunks, chunk_adc, coef,
                 inv_step, step, hi, stream);
      break;
    case 32:
      launch<32>(x, w, noise, out, m, k, d, n, n_chunks, chunk_adc, coef,
                 inv_step, step, hi, stream);
      break;
    case 64:
      launch<64>(x, w, noise, out, m, k, d, n, n_chunks, chunk_adc, coef,
                 inv_step, step, hi, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
