// Chunked TAOM-array GEMM with the BPCA / per-chunk-ADC accumulation
// policies, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.taom_gemm.taom_gemm_quantized
// (bodies _kernel_analog_carry and _kernel_chunk_adc).  Two routes:
//
//   * the fused int8 route (taom_gemm_int8, operands of bits <= 7, so
//     |q| <= qmax <= 127): the whole of the reference's quantize -> TAOM
//     GEMM -> rescale in two launches.  taom_gemm_absmax_kernel writes
//     per-block partial maxima of |x|, every column's weight scale and w
//     quantized once to s8 in the GEMM's staged layout (k-contiguous,
//     chunks cut into zero-padded pieces); taom_gemm_int8_kernel reduces
//     the partials to x's scale, quantizes x into shared memory as s8,
//     multiplies on the tensor cores (mma.sync m16n8k32 s8 x s8 -> s32,
//     exact), applies the policy per chunk and rescales and casts in its
//     epilogue.
//   * the float32 body (taom_gemm_f32, any bits): pre-quantized,
//     integer-valued float32 operands on the CUDA cores; the caller
//     quantizes and rescales.
//
// Both take pre-sampled standard-normal noise: (M, D) for analog carry,
// (C, M, D) for chunk-ADC, C = ceil(K / N) — or a null pointer when noise
// is off, and then the noise term is left out.
//
//   analog carry (HEANA, *_bpca): acc = sum_c psum_c, in chunk order;
//       v = acc + coef * noise[m, d]          (coef = f32(sigma * sqrt(C)))
//       out = adc(v)                          (one ADC per output)
//   chunk-ADC (AMW, MAW): out = sum_c adc(psum_c + coef * noise[c, m, d])
//                                             (coef = f32(sigma))
//   adc(v) = clamp(rint(v * inv_step), -hi, hi) * step
//   int8 route only: y = out * (sx * sw[d]), cast to x's type, with
//   sx = max(max|x|, eps) * f32(1/qmax) (per tensor), sw[d] the same over
//   column d of w, and q = clamp(rint(v / s), -qmax, qmax) (IEEE division).
//
// Bound on this card: memory.  At the main path's shapes (K <= 144,
// D <= 64; and the photonic LM's K 768-1536, D 768-3352) a GEMM does
// 2*K*D operations for every row of x it reads, below the card's
// operation-per-byte balance at int8 rates, so the least time is bytes /
// bandwidth: x, w and the output once (plus the noise when it is on).
// What the designs do about it:
//   * int8 route: quantize and rescale run inside the two kernels (the
//     unfused route makes ~16 elementwise passes over x, w and the output);
//     the tile's height is chosen so that a GEMM launches at least 2 x 132
//     blocks where M allows; w is quantized once and copied into shared
//     memory with cp.async, the next piece while this one is multiplied,
//     and so are x's raw rows where they are 16-byte aligned and K has 3
//     pieces or more; the chunk sums stay in registers.  Each tile still
//     quantizes its own copy of x's rows (once per column tile), which
//     holds it above the bound at the LM's widths.
//   * float32 body: one block owns an output tile as wide as D (up to 64
//     columns), so every row of xq is read from device memory once; the
//     chunk loop runs inside the block and the BPCA accumulator stays in
//     registers; ragged M, D and K edges are masked in the loads.
//
// Numerics: every rounding of the reference is kept as a separate IEEE
// float operation (__fmul_rn / __fadd_rn / __fdiv_rn, rintf = round half to
// even, and the file is built with --fmad=false), so both routes equal the
// plain PyTorch version bit for bit wherever the integer chunk psums stay
// below 2^24.  The int8 route's s32 chunk sums are exact; converted once to
// float32 (__int2float_rn) they are the reference's float32 chunk dot
// products, which are exact integers below 2^24.  Inside a chunk the float32
// body accumulates with fmaf: integer products and sums below 2^24 are exact
// in any order and with or without fusion.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// The fused int8 route.
// ---------------------------------------------------------------------------
constexpr int kColGroup = 32;       // w columns per absmax block
constexpr int kMaxWarps = 4;        // GEMM block: 1, 2 or 4 row warps
constexpr int kWarpCols = 64;       // a warp's columns at most
constexpr int kItemsInFlight = 8;   // x words a thread loads at once
constexpr int kSlotPad = 16;        // bytes past each staged row (below)

// Elements of one 16-byte vector.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float ld_elem(const float* p) { return *p; }
__device__ __forceinline__ float ld_elem(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One aligned 16-byte load, widened to float32 (exact for bf16).
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[4]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(words[j] << 16);
    v[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void st_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max that keeps a NaN, as torch's amax does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// A quantization scale and what the fast path of quant_int needs.
struct Scale {
  float s;        // the scale
  float r;        // fl(1 / s)
  bool fast;      // r is a normal float: the fast path's bound holds
};

__device__ __forceinline__ Scale make_scale(float s) {
  const float r = __frcp_rn(s);
  return {s, r, r >= 1.17549435e-38f && r <= 3.40282347e38f};
}

// The reference's quantize, clamp(rint(v / s), -qmax, qmax), as an int.
// Fast path: t = fl(v * fl(1/s)) lies within 2^-22 |t| of v / s, and so
// does the correctly rounded quotient fl(v / s) (two roundings of 2^-24
// each, and one of 2^-24), so a half-integer farther than 2^-21 |t| from t
// cannot lie between them and rint(t) == rint(fl(v / s)).  Nearer to a
// half-integer (about one value in 10^4), or with a subnormal 1/s, the
// IEEE division itself decides.  (A NaN operand makes its scale NaN, and
// then every output it reaches NaN whatever q is.)
__device__ __forceinline__ int quant_int(float v, const Scale& sc, int qmax) {
  const float t = __fmul_rn(v, sc.r);
  int q = __float2int_rn(t);
  const float off = fabsf(__fsub_rn(t, __int2float_rn(q)));
  if (!sc.fast ||
      !(fabsf(__fsub_rn(off, 0.5f)) > __fmul_rn(fabsf(t), 0x1p-21f))) {
    q = __float2int_rn(__fdiv_rn(v, sc.s));
  }
  return min(max(q, -qmax), qmax);
}

// Four quantized values as the s8 bytes of one 32-bit word (v[0] lowest).
__device__ __forceinline__ uint32_t quant_word(const float (&v)[4],
                                               const Scale& sc, int qmax) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    word |= (static_cast<uint32_t>(quant_int(v[j], sc, qmax)) & 0xffu)
            << (8 * j);
  return word;
}

// Where K position kk of w lies in the staged layout: chunk c = kk / n is
// cut into pieces of `slot` positions (ppc pieces a chunk), and piece i of
// chunk c is stored at bytes [(c * ppc + i) * slot, + slot) of the column.
__device__ __forceinline__ int staged_pos(int kk, int n, int slot, int ppc) {
  const int c = kk / n;
  const int within = kk - c * n;
  const int piece = within / slot;
  return (c * ppc + piece) * slot + (within - piece * slot);
}

// Blocks [0, n_xblocks) write partial maxima of |x| to partials.  The
// others each own 32 columns of w: they write the columns' scales
// sw[d] = max(max_k |w[k, d]|, eps) * inv_qmax and the quantized columns
// as s8 rows of kp bytes in the GEMM's staged layout (staged_pos, zeros
// past each chunk's end), through a transposing tile in shared memory so
// that reads and writes are coalesced.  No atomics, no memset.
template <typename XT, typename WT, int kAbsThreads>
__global__ void __launch_bounds__(kAbsThreads)
taom_gemm_absmax_kernel(const XT* __restrict__ x, long long nx, int x_vec,
                        const WT* __restrict__ w, int k, int d, int n,
                        int n_chunks, int slot, int kp, int n_xblocks,
                        float* __restrict__ partials, float* __restrict__ sw,
                        unsigned char* __restrict__ wq, float eps,
                        float inv_qmax, float qmax) {
  constexpr int kRowGroups = kAbsThreads / kColGroup;
  constexpr int kPerThread = 8;
  constexpr int kKTile = kPerThread * kRowGroups;   // K rows per w tile
  __shared__ float red[kAbsThreads];
  __shared__ unsigned char tile[kColGroup][kKTile + 1];
  const int tid = threadIdx.x;
  float mx = 0.0f;
  if (static_cast<int>(blockIdx.x) < n_xblocks) {
    const long long first =
        static_cast<long long>(blockIdx.x) * kAbsThreads + tid;
    const long long stride = static_cast<long long>(n_xblocks) * kAbsThreads;
    long long done = 0;
    if (x_vec) {
      constexpr int V = Vec<XT>::n;
      const long long nv = nx / V;
#pragma unroll 4
      for (long long i = first; i < nv; i += stride) {
        float v[V];
        ld_vec(x + i * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) mx = nan_max(mx, fabsf(v[j]));
      }
      done = nv * V;
    }
#pragma unroll 4
    for (long long i = done + first; i < nx; i += stride)
      mx = nan_max(mx, fabsf(ld_elem(x + i)));
    // A shuffle reduction in each warp, then one across the warps.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if ((tid & 31) == 0) red[tid >> 5] = mx;
    __syncthreads();
    if (tid < 32) {
      mx = tid < kAbsThreads / 32 ? red[tid] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (tid == 0) partials[blockIdx.x] = mx;
    }
    return;
  }
  const int c0 = (blockIdx.x - n_xblocks) * kColGroup;
  const int lc = tid % kColGroup;
  const int rg = tid / kColGroup;
  const int col = c0 + lc;
  const WT* wc = w + col;
  if (col < d) {
    for (int k0 = 0; k0 < k; k0 += kKTile) {
      float v[kPerThread];
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int kk = k0 + rg + u * kRowGroups;
        v[u] = kk < k ? ld_elem(wc + static_cast<long long>(kk) * d) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) mx = nan_max(mx, fabsf(v[u]));
    }
  }
  red[tid] = mx;
  __syncthreads();
  if (tid < kColGroup) {
    float m = red[tid];
    for (int g = 1; g < kRowGroups; ++g)
      m = nan_max(m, red[g * kColGroup + tid]);
    const float s = __fmul_rn(nan_max(m, eps), inv_qmax);
    red[tid] = s;
    if (col < d) sw[col] = s;
  }
  __syncthreads();
  const Scale sc = make_scale(red[lc]);
  const int iqmax = static_cast<int>(qmax);
  const int ppc = (n + slot - 1) / slot;
  for (int k0 = 0; k0 < k; k0 += kKTile) {
    // Load and quantize a (kKTile k) x (32 columns) tile, k-major in shared.
    float v[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int kk = k0 + rg + u * kRowGroups;
      v[u] = (col < d && kk < k)
                 ? ld_elem(wc + static_cast<long long>(kk) * d) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u)
      tile[lc][rg + u * kRowGroups] =
          static_cast<unsigned char>(quant_int(v[u], sc, iqmax));
    __syncthreads();
    // Write it out column by column, a byte a thread.
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = tid + u * kAbsThreads;
      const int c = i / kKTile;
      const int kk = k0 + i % kKTile;
      if (c0 + c < d && kk < k)
        wq[static_cast<long long>(c0 + c) * kp +
           staged_pos(kk, n, slot, ppc)] = tile[c][kk - k0];
    }
    __syncthreads();
  }
  // Zeros past the end of each chunk's last piece.
  for (int i = tid; i < kColGroup * n_chunks; i += kAbsThreads) {
    const int c = i / n_chunks;
    const int chunk = i - c * n_chunks;
    if (c0 + c >= d) continue;
    const int clen = min(n, k - chunk * n);
    const int last = (clen - 1) / slot;
    unsigned char* dst = wq + static_cast<long long>(c0 + c) * kp +
                         (chunk * ppc + last) * slot;
    for (int p = clen - last * slot; p < slot; ++p) dst[p] = 0;
  }
}

struct Int8Args {
  const void* x;               // (M, K) XT, row-major
  const float* noise;          // see the header, or null
  void* out;                   // (M, D) XT
  const unsigned char* wq;     // (D, kp) s8: w quantized, staged layout
  const float* partials;       // n_partials partial maxima of |x|
  const float* sw;             // (D,) column scales of w
  int m, k, d, n, n_chunks, chunk_adc, n_partials, kp;
  int slot;                    // staged K positions, a multiple of 32
  float coef, inv_step, step, hi, qmax, inv_qmax, eps;
};

// Stage rows [m0, m0 + rows) of x at K positions [start, start + len) into
// xs[r * stride + p] as s8, a 32-bit word (4 positions) an item and
// kItemsInFlight items a thread at once; zeros past len (up to slot) and
// past M.
template <typename T>
__device__ __forceinline__ void stage_x(unsigned char* xs, const T* x,
                                        long long m0, int rows, int m, int k,
                                        int start, int len, int slot,
                                        int stride, const Scale& sc,
                                        int qmax) {
  constexpr int U = kItemsInFlight;
  const int wpr = slot >> 2;
  const int items = rows * wpr;
  const int nthr = blockDim.x;
  for (int base = threadIdx.x; base < items; base += nthr * U) {
    float v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int item = base + u * nthr;
      const int r = item / wpr;
      const int p = 4 * (item - r * wpr);
      const long long gm = m0 + r;
      const T* src = x + gm * k + start + p;
      const bool row = item < items && gm < m;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[u][j] = (row && p + j < len) ? ld_elem(src + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int item = base + u * nthr;
      if (item >= items) continue;
      const int r = item / wpr;
      const int p = 4 * (item - r * wpr);
      *reinterpret_cast<uint32_t*>(xs + r * stride + p) =
          quant_word(v[u], sc, qmax);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start the copy of columns [d0, d0 + BD) of the quantized w's piece
// `piece` into ws[col * stride + p] (k-contiguous: mma's .col B layout),
// 16 bytes a cp.async.  Columns past D are never written (the caller
// zeroes them once).  The pieces are already padded with zeros.
template <int BD>
__device__ __forceinline__ void copy_w_async(unsigned char* ws,
                                             const unsigned char* wq, int d0,
                                             int d, int kp, int piece,
                                             int slot, int stride) {
  const int vpc = slot >> 4;
  const int cols = min(BD, d - d0);
  for (int i = threadIdx.x; i < cols * vpc; i += blockDim.x) {
    const int c = i / vpc;
    const int q = i - c * vpc;
    cp_async16(ws + c * stride + 16 * q,
               wq + static_cast<long long>(d0 + c) * kp + piece * slot +
                   16 * q);
  }
}

// Start the copy of rows [m0, m0 + rows) of x, K positions [start, start +
// len) widened to whole 16-byte vectors, into xr[r * rw + e] (elements):
// position start + p lands at element (start % V) + p.  Needs x 16-byte
// aligned and K % V == 0 (so no vector passes a row's end).
template <typename T>
__device__ __forceinline__ void copy_x_async(T* xr, const T* x,
                                             long long m0, int rows, int m,
                                             int k, int start, int len,
                                             int rw) {
  constexpr int V = Vec<T>::n;
  const int a0 = start / V * V;
  const int nv = (start + len - a0 + V - 1) / V;
  const int live = static_cast<int>(min(static_cast<long long>(rows),
                                        m - m0));
  for (int i = threadIdx.x; i < live * nv; i += blockDim.x) {
    const int r = i / nv;
    const int q = i - r * nv;
    cp_async16(xr + r * rw + q * V, x + (m0 + r) * k + a0 + q * V);
  }
}

// Quantize the raw x piece in xr (copy_x_async's layout) into
// xs[r * stride + p] as s8, a 32-bit word (4 positions) an item; zeros
// past len (up to slot) and past M.
template <typename T>
__device__ __forceinline__ void quantize_x(unsigned char* xs, const T* xr,
                                           long long m0, int rows, int m,
                                           int start, int len, int slot,
                                           int stride, int rw,
                                           const Scale& sc, int qmax) {
  constexpr int V = Vec<T>::n;
  const int o = start % V;
  const int wpr = slot >> 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * wpr; i += blockDim.x) {
    const int r = i / wpr;
    const int p = 4 * (i - r * wpr);
    const bool row = m0 + r < m;
    const T* src = xr + r * rw + o + p;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (row && p + j < len) ? ld_elem(src + j) : 0.0f;
    *reinterpret_cast<uint32_t*>(xs + r * stride + p) =
        quant_word(v, sc, qmax);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory of one block: the s8 x tile, two s8 w tiles and, with
// ASYNC, two raw x tiles.
template <typename XT, int BD, bool ASYNC>
int int8_smem_bytes(int bm, int slot) {
  const int stride = slot + kSlotPad;
  const int raw = ASYNC ? 2 * bm * (slot + 2 * Vec<XT>::n) *
                              static_cast<int>(sizeof(XT)) : 0;
  return raw + (bm + 2 * BD) * stride;
}

// One block computes a (16 * warps) x BD output tile with warps x WN
// warps (WN = BD / 64 for BD 128, else 1): warp (i, j) owns rows 16 i ..
// 16 i + 15 and columns j * BD / WN .. of it, as BD / WN / 8 mma tiles.  K is
// walked piece by piece (each chunk cut into pieces of at most `slot`
// positions): the next piece's w (and, with ASYNC, its raw x rows) is
// copied with cp.async into the other of two buffers while this piece is
// quantized into s8 and summed on the tensor cores in s32; at a chunk's
// end the s32 sums are converted and the policy applied.  Without ASYNC
// (x not 16-byte aligned, a row not a whole number of vectors, or fewer
// than 3 pieces) x is loaded and quantized straight from device memory.  Row stride slot + 16
// bytes (= 16 mod 32) puts the 8 rows of a fragment load on 8 distinct
// groups of 4 banks.
//
// Fragments of m16n8k32 (PTX ISA; g = lane / 4, t = lane % 4):
//   A (16 x 32 s8, row): a[0] = row g,   k 4t..4t+3;  a[1] = row g+8, same k;
//                        a[2] = row g,   k 16+4t..;   a[3] = row g+8, same k
//   B (32 x 8 s8, col):  b[0] = col g,   k 4t..4t+3;  b[1] = col g, k 16+4t..
//   C (16 x 8 s32):      c[0], c[1] = row g,   cols 2t, 2t+1;
//                        c[2], c[3] = row g+8, cols 2t, 2t+1
template <typename XT, int BD, bool ASYNC>
__global__ void __launch_bounds__(32 * kMaxWarps * 2)
taom_gemm_int8_kernel(const Int8Args a) {
  constexpr int WN = BD > kWarpCols ? BD / kWarpCols : 1;
  constexpr int NT = BD / WN / 8;
  constexpr int V = Vec<XT>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sw_s[BD];
  __shared__ float red[kMaxWarps * 2];
  __shared__ float sx_s;

  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int wm = warp / WN;              // the warp's 16 rows
  const int wn = (warp % WN) * (BD / WN);  // and its first column
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bm = 16 * (warps / WN);
  const int stride = a.slot + kSlotPad;
  const int rw = a.slot + 2 * V;
  XT* xr[2];
  xr[0] = reinterpret_cast<XT*>(smem);
  xr[1] = xr[0] + (ASYNC ? bm * rw : 0);
  unsigned char* xs = reinterpret_cast<unsigned char*>(xr[1] +
                                                       (ASYNC ? bm * rw : 0));
  unsigned char* ws[2] = {xs + bm * stride, xs + (bm + BD) * stride};
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int d0 = blockIdx.y * BD;
  const int ppc = (a.n + a.slot - 1) / a.slot;

  // Zero both w tiles once: columns past D are never copied in.
  for (int i = tid; i < 2 * BD * stride / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(ws[0])[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // The first piece's copies fly while the scales are reduced.
  copy_w_async<BD>(ws[0], a.wq, d0, a.d, a.kp, 0, a.slot, stride);
  if (ASYNC)
    copy_x_async(xr[0], x, m0, bm, a.m, a.k, 0, min(a.slot, min(a.n, a.k)),
                 rw);
  cp_async_commit();

  // x's scale from the partial maxima; the tile's column scales.
  float mx = 0.0f;
#pragma unroll 8
  for (int i = tid; i < a.n_partials; i += blockDim.x)
    mx = nan_max(mx, a.partials[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  for (int i = tid; i < BD; i += blockDim.x)
    sw_s[i] = d0 + i < a.d ? a.sw[d0 + i] : 0.0f;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int i = 1; i < warps; ++i) m = nan_max(m, red[i]);
    sx_s = __fmul_rn(nan_max(m, a.eps), a.inv_qmax);
  }
  __syncthreads();
  const float sx = sx_s;
  const Scale sc = make_scale(sx);
  const int iqmax = static_cast<int>(a.qmax);

  float carry[NT][4];
  int ps[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      carry[j][e] = 0.0f;
      ps[j][e] = 0;
    }

  const unsigned char* arow = xs + (wm * 16 + g) * stride + 4 * t;
  int c = 0, p0 = 0, buf = 0;
  while (c < a.n_chunks) {
    const int cs = c * a.n;
    const int clen = min(a.n, a.k - cs);
    const int len = min(a.slot, clen - p0);
    // The next piece, into the other buffers.
    int nc = c, np0 = p0 + a.slot;
    if (np0 >= clen) {
      ++nc;
      np0 = 0;
    }
    if (nc < a.n_chunks) {
      copy_w_async<BD>(ws[buf ^ 1], a.wq, d0, a.d, a.kp,
                       nc * ppc + np0 / a.slot, a.slot, stride);
      if (ASYNC) {
        const int ns = nc * a.n + np0;
        copy_x_async(xr[buf ^ 1], x, m0, bm, a.m, a.k, ns,
                     min(a.slot, min(a.n, a.k - nc * a.n) - np0), rw);
      }
    }
    cp_async_commit();
    if (!ASYNC)
      stage_x(xs, x, m0, bm, a.m, a.k, cs + p0, len, a.slot, stride, sc,
              iqmax);
    cp_async_wait_one();
    __syncthreads();
    if (ASYNC) {
      quantize_x(xs, xr[buf], m0, bm, a.m, cs + p0, len, a.slot, stride, rw,
                 sc, iqmax);
      __syncthreads();
    }
    const int ksteps = (len + 31) / 32;
    for (int kk = 0; kk < ksteps; ++kk) {
      const unsigned char* r = arow + kk * 32;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(r);
      af[1] = *reinterpret_cast<const uint32_t*>(r + 8 * stride);
      af[2] = *reinterpret_cast<const uint32_t*>(r + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(r + 8 * stride + 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* col =
            ws[buf] + (wn + j * 8 + g) * stride + kk * 32 + 4 * t;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(col);
        bf[1] = *reinterpret_cast<const uint32_t*>(col + 16);
        mma_s8(ps[j], af, bf);
      }
    }
    __syncthreads();

    if (nc != c) {   // the chunk's last piece: convert, policy
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = __int2float_rn(ps[j][e]);
          ps[j][e] = 0;
          if (a.chunk_adc) {
            const long long gm = m0 + wm * 16 + g + (e >> 1) * 8;
            const int gd = d0 + wn + j * 8 + 2 * t + (e & 1);
            if (a.noise != nullptr && gm < a.m && gd < a.d) {
              const float z =
                  a.noise[(static_cast<long long>(c) * a.m + gm) * a.d + gd];
              v = __fadd_rn(v, __fmul_rn(a.coef, z));
            }
            v = adc_round(v, a.inv_step, a.step, a.hi);
          }
          carry[j][e] = __fadd_rn(carry[j][e], v);
        }
    }
    c = nc;
    p0 = np0;
    buf ^= 1;
  }

  XT* __restrict__ out = static_cast<XT*>(a.out);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long gm = m0 + wm * 16 + g + (e >> 1) * 8;
      const int col = wn + j * 8 + 2 * t + (e & 1);
      const int gd = d0 + col;
      if (gm >= a.m || gd >= a.d) continue;
      const long long o = gm * a.d + gd;
      float v = carry[j][e];
      if (!a.chunk_adc) {
        if (a.noise != nullptr)
          v = __fadd_rn(v, __fmul_rn(a.coef, a.noise[o]));
        v = adc_round(v, a.inv_step, a.step, a.hi);
      }
      st_elem(out + o, __fmul_rn(v, __fmul_rn(sx, sw_s[col])));
    }
}

template <typename XT, int BD, bool ASYNC>
cudaError_t launch_int8(const Int8Args& a, int warps, cudaStream_t stream) {
  constexpr int WN = BD > kWarpCols ? BD / kWarpCols : 1;
  const int bm = 16 * warps;
  const dim3 grid((a.m + bm - 1) / bm, (a.d + BD - 1) / BD);
  const int smem = int8_smem_bytes<XT, BD, ASYNC>(bm, a.slot);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        taom_gemm_int8_kernel<XT, BD, ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  taom_gemm_int8_kernel<XT, BD, ASYNC>
      <<<grid, 32 * warps * WN, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT, int BD>
cudaError_t launch_int8(const Int8Args& a, int warps, bool async,
                        cudaStream_t stream) {
  return async ? launch_int8<XT, BD, true>(a, warps, stream)
               : launch_int8<XT, BD, false>(a, warps, stream);
}

template <typename XT, typename WT>
cudaError_t launch_fused(Int8Args a, const WT* w, unsigned char* scratch,
                         int tile_d, int warps, int n_xblocks,
                         int x_vec, cudaStream_t stream) {
  unsigned char* wq = scratch;
  float* partials = reinterpret_cast<float*>(
      scratch + static_cast<long long>(a.d) * a.kp);
  float* sw = partials + n_xblocks;
  const int col_blocks = (a.d + kColGroup - 1) / kColGroup;
  // Long columns of w take 1024 threads (32 rows of a column at once), the
  // short ones of the CNN's GEMMs 256.
  const XT* x = static_cast<const XT*>(a.x);
  const long long nx = static_cast<long long>(a.m) * a.k;
  if (a.k > 256) {
    taom_gemm_absmax_kernel<XT, WT, 1024>
        <<<n_xblocks + col_blocks, 1024, 0, stream>>>(
            x, nx, x_vec, w, a.k, a.d, a.n, a.n_chunks, a.slot, a.kp,
            n_xblocks, partials, sw, wq, a.eps, a.inv_qmax, a.qmax);
  } else {
    taom_gemm_absmax_kernel<XT, WT, 256>
        <<<n_xblocks + col_blocks, 256, 0, stream>>>(
            x, nx, x_vec, w, a.k, a.d, a.n, a.n_chunks, a.slot, a.kp,
            n_xblocks, partials, sw, wq, a.eps, a.inv_qmax, a.qmax);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.wq = wq;
  a.partials = partials;
  a.n_partials = n_xblocks;
  a.sw = sw;
  // Double-buffering x pays from the third piece on; before that the raw
  // buffers only cost resident blocks.
  const int pieces = a.kp / a.slot;
  const bool async = x_vec && a.k % Vec<XT>::n == 0 && pieces >= 3;
  switch (tile_d) {
    case 8: return launch_int8<XT, 8>(a, warps, async, stream);
    case 16: return launch_int8<XT, 16>(a, warps, async, stream);
    case 32: return launch_int8<XT, 32>(a, warps, async, stream);
    case 64: return launch_int8<XT, 64>(a, warps, async, stream);
    case 128: return launch_int8<XT, 128>(a, warps, async, stream);
    default: return cudaErrorInvalidValue;
  }
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

// Plain C entry point of the fused int8 route (loaded with ctypes).  x and
// out are float32 (x_bf16 = 0) or bfloat16 (1); w float32 or bfloat16
// (w_bf16).  scratch holds d * kp bytes of quantized w (kp = n_chunks *
// ceil(n / slot) * slot), then n_xblocks + d floats; the wrapper allocates
// it.
// tile_d is 8, 16, 32, 64 or 128 columns; the tile is 16 * warps rows high,
// warps 1, 2 or 4; slot is the number of K positions staged at once (a
// multiple of 32, at most 192).  x_vec says x is 16-byte aligned: the
// absmax kernel then reads it in 16-byte vectors, and the GEMM copies its
// rows with cp.async where K allows.  Returns the first nonzero
// cudaGetLastError() of the launches (and of raising a kernel's shared
// memory limit), or 0.
extern "C" int taom_gemm_int8(const void* x, const void* w,
                              const float* noise, void* out, void* scratch,
                              int x_bf16, int w_bf16, int m, int k, int d,
                              int n, int n_chunks, int chunk_adc, float coef,
                              float inv_step, float step, float hi,
                              float qmax, float inv_qmax, float eps,
                              int tile_d, int warps, int slot, int n_xblocks,
                              int kp, int x_vec, void* stream_ptr) {
  const bool tile_ok = tile_d == 8 || tile_d == 16 || tile_d == 32 ||
                       tile_d == 64 || tile_d == 128;
  const bool warps_ok = warps == 1 || warps == 2 || warps == kMaxWarps;
  if (!tile_ok || !warps_ok || slot < 32 || slot % 32 != 0 || slot > 192 ||
      n_xblocks < 1 || kp != n_chunks * ((n + slot - 1) / slot) * slot) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  Int8Args a{};
  a.x = x;
  a.noise = noise;
  a.out = out;
  a.m = m;
  a.k = k;
  a.d = d;
  a.n = n;
  a.n_chunks = n_chunks;
  a.chunk_adc = chunk_adc;
  a.kp = kp;
  a.slot = slot;
  a.coef = coef;
  a.inv_step = inv_step;
  a.step = step;
  a.hi = hi;
  a.qmax = qmax;
  a.inv_qmax = inv_qmax;
  a.eps = eps;
  using bf16 = __nv_bfloat16;
  const bf16* wb = static_cast<const bf16*>(w);
  const float* wf = static_cast<const float*>(w);
  cudaError_t err;
  if (x_bf16) {
    err = w_bf16 ? launch_fused<bf16, bf16>(a, wb, buf, tile_d, warps,
                                            n_xblocks, x_vec, stream)
                 : launch_fused<bf16, float>(a, wf, buf, tile_d, warps,
                                             n_xblocks, x_vec, stream);
  } else {
    err = w_bf16 ? launch_fused<float, bf16>(a, wb, buf, tile_d, warps,
                                             n_xblocks, x_vec, stream)
                 : launch_fused<float, float>(a, wf, buf, tile_d, warps,
                                              n_xblocks, x_vec, stream);
  }
  return static_cast<int>(err);
}
