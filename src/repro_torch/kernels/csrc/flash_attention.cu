// Forward flash attention (causal / sliding-window), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro.kernels.flash_attention.flash_attention_fwd (flash_attention.py:75,
// body _kernel at :33).  Inputs q, k, v (BH, S, D), row-major, heads folded
// into the batch axis (GQA callers expand K and V per head first), all
// float32 or all bfloat16; output o (BH, S, D) in the same type.  Per row:
//
//   s[qi, kj] = (q_qi . k_kj) * D**-0.5      in float32
//   s[qi, kj] = -1e30  unless kj < S, (causal) kj <= qi,
//                             (window) kj > qi - window
//   o[qi]     = softmax_kj(s[qi]) . v       (online softmax, below)
//
// with the TPU kernel's numerics: running max m, sum l and accumulator
// acc in float32; per key tile m_new = max(m, max s), p = exp(s - m_new),
// corr = exp(m - m_new), l = l corr + sum p, acc = acc corr + p v;
// o = acc / max(l, 1e-30).  Masked scores are set to -1e30, never
// multiplied by a 0/1 mask: a row whose keys are all masked so far keeps
// m = -1e30 and p = exp(0) = 1 (finite), and the first valid key's
// corr = exp(-1e30 - m_new) = 0 cancels what it summed.
//
// What is carried over from the TPU kernel, and what is not: the TPU grid
// (BH, S/bq, S/bk) carries m, l and acc across its sequential key axis in
// VMEM.  Here one block owns one (bh, 64-row query tile), keeps the query
// tile in shared memory and m, l and acc in registers, and loops over the
// 64-row key tiles itself, staging each K and V tile in shared memory
// (converted to float32).  Key tiles wholly above the diagonal, or wholly
// before the window of the tile's first query row, are skipped: their
// contribution is exactly 0 (p = exp(-1e30 - m) = 0, corr = 1) or
// cancelled (corr = 0), so the result does not change.  The TPU kernel
// cannot skip them.  Blocks are issued heaviest query tile first.
//
// Bound on this card: at the served shape (qwen2-0.5b, D 64, S 1000, bf16)
// the causal work is 4 D S(S+1)/2 flops per row against 8 S D bytes, ~250
// flops a byte, above the bf16 tensor cores' balance (989 TFLOP/s over
// 3.35 TB/s = 295) only just, and far above the float32 CUDA cores' (20).
// This kernel runs the products in float32 on the CUDA cores, so 67
// TFLOP/s bounds it, not 989.  What the design does about that: the two
// products (scores Q K^T and P V) run as register-tiled products out of
// shared memory — 256 threads, each holding a 4 x 4 tile of scores and a
// 4-row x 4*NG-column tile of the accumulator, reading 16-byte vectors
// that a half-warp shares or that fall on distinct banks (row strides
// padded by 4 floats) — so the FMA units, not the shared-memory port, set
// the pace; the row statistics are reduced with warp shuffles inside a
// half-warp.  Tensor cores (bf16 mma for Q K^T, whose products are exact
// in float32), TMA and double-buffered tiles are later work; P V on bf16
// tensor cores would round P, which the reference keeps in float32.
//
// D is zero-padded to NG * 64 columns in shared memory (NG = 1..4, so D up
// to 256); the loads mask rows >= S and columns >= D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // query rows and key rows per tile
constexpr int kLdp = kTile + 4;       // row stride of P
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int NG>
constexpr int smem_floats() {
  return 3 * kTile * (NG * 64 + 4) + kTile * kLdp;
}

// Rows [r0, r0 + kTile) of a (S, D) matrix into a [kTile][DP + 4] float32
// tile, zero where the row is >= S or the column >= D.
template <typename T, int DP>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int r0, int S, int D) {
  constexpr int ld = DP + 4;
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int row = r0 + r;
    float x = 0.0f;
    if (row < S && d < D) x = to_f32(src[(long long)row * D + d]);
    dst[r * ld + d] = x;
  }
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int S, int D, int n_qtiles, float scale,
                           int causal, int window) {
  constexpr int DP = NG * 64;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [kTile][LD]
  float* ks = qs + kTile * LD;          // [kTile][LD]
  float* vs = ks + kTile * LD;          // [kTile][LD]
  float* ps = vs + kTile * LD;          // [kTile][kLdp]

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // score columns tx + 16 j
  const int ty = tid >> 4;              // rows 4 ty .. 4 ty + 3
  const long long bh = blockIdx.x / n_qtiles;
  // Heaviest query tile first: under the causal mask the last tile of a
  // row reads the most key tiles.
  const int qt = n_qtiles - 1 - (int)(blockIdx.x - bh * n_qtiles);
  const int q0 = qt * kTile;
  const long long base = bh * (long long)S * D;
  const int d4_end = (D + 3) >> 2;      // float4 columns holding data

  stage<T, DP>(q + base, qs, q0, S, D);

  float m[4], l[4];
  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.0f;
  }

  // Key tiles that can hold a valid key for a real row of this tile.
  const int last_row = min(q0 + kTile, S) - 1;
  const int k_end = causal ? last_row + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();                    // the last tile's P V is done
    stage<T, DP>(k + base, ks, k0, S, D);
    stage<T, DP>(v + base, vs, k0, S, D);
    __syncthreads();

    // Scores: a 4 x 4 register tile, rows 4 ty + i, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d4 = 0; d4 < d4_end; ++d4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(qs + (4 * ty + i) * LD + 4 * d4);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ld4(ks + (tx + 16 * j) * LD + 4 * d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // Mask, then the online-softmax update of each row; the 16 threads of
    // a half-warp share a row and reduce over it with shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < S;                // padded keys are never attended
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(4 * ty + i) * kLdp + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr;
    }
    __syncthreads();                    // P is whole

    // acc += P V: rows 4 ty + i, columns 4 (tx + 16 g) .. + 3.
    for (int t4 = 0; t4 < kTile / 4; ++t4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ld4(ps + (4 * ty + i) * kLdp + 4 * t4);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vb = ld4(vs + (4 * t4 + t) * LD + 4 * (tx + 16 * g));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pa[i], t);
            acc[i][g][0] = fmaf(p, vb.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vb.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vb.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vb.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + base + (long long)row * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * (tx + 16 * g) + c;
        if (col < D) out[col] = from_f32<T>(acc[i][g][c] / denom);
      }
  }
}

template <typename T, int NG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int S, int D, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<NG>() * (int)sizeof(float);
  auto kernel = flash_attention_fwd_kernel<T, NG>;
  // The dynamic shared-memory limit is a property of the function on the
  // current device: raise it once per device, on the first call, so that
  // later calls (inside a CUDA graph capture, say) launch and nothing
  // else.
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const int n_qtiles = (S + kTile - 1) / kTile;
  kernel<<<(unsigned)((long long)bh * n_qtiles), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, D, n_qtiles, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int S, int D, float scale, int causal,
                     int window, cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, bh, S, D, scale, causal, window, stream);
    case 2: return launch<T, 2>(q, k, v, o, bh, S, D, scale, causal, window, stream);
    case 3: return launch<T, 3>(q, k, v, o, bh, S, D, scale, causal, window, stream);
    case 4: return launch<T, 4>(q, k, v, o, bh, S, D, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the launch's CUDA error code (0:
// launched); the wrapper (kernels/flash_attention.py) checks the shapes.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bh, int S,
                                   int D, float scale, int causal, int window,
                                   int dtype, void* stream) {
  if (bh < 1 || S < 1 || D < 1 || D > 256 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, o, bh, S, D, scale, causal,
                                   window, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, S, D, scale,
                                             causal, window, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
