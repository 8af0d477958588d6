// Chunked TAOM-array GEMM with the BPCA / per-chunk-ADC accumulation
// policies, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.taom_gemm.taom_gemm_quantized
// (bodies _kernel_analog_carry and _kernel_chunk_adc).  Two routes:
//
//   * the fused s8 route (taom_gemm_int8): the whole of the reference's
//     quantize -> TAOM GEMM -> rescale in two launches, or three.  Operands
//     of bits <= 7 (|q| <= qmax <= 127) are one s8 plane; 8-bit operands
//     (|q| <= 255) with N * qmax^2 < 2^24 are two (below).
//     taom_gemm_absmax_kernel writes per-block partial maxima of |x|, every
//     column's weight scale and w quantized once to s8 planes in the GEMM's
//     staged layout (k-contiguous, chunks cut into zero-padded pieces);
//     where the GEMM has more than one column tile or K has four pieces or
//     more (and staging does not inflate x), taom_gemm_quant_x_kernel
//     quantizes x once into s8 planes of the same layout.  x may instead be
//     a convolution's NHWC input read as its windows (implicit im2col,
//     Windows below): the absmax kernel then reduces |x| over the pixels
//     some window covers and taom_gemm_quant_x_kernel, always launched,
//     gathers each window's elements, so that no im2col matrix is written;
//     taom_gemm_int8_kernel reduces the partials to x's scale, quantizes x
//     into shared memory (or copies its planes in), multiplies on the
//     tensor cores (mma.sync m16n8k32 s8 x s8 -> s32, exact), applies the
//     policy per chunk and rescales and casts in its epilogue; for chunks
//     of at most kSmallMaxN positions taom_gemm_small_kernel does the same
//     on the CUDA cores (below).
//   * the float32 body (taom_gemm_f32, any bits; the route of bits >= 9 and
//     of 8 bits at N >= 259): pre-quantized, integer-valued float32
//     operands on the CUDA cores; the caller quantizes and rescales.
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
//   s8 route only: y = out * (sx * sw[d]), cast to x's type, with
//   sx = max(max|x|, eps) * f32(1/qmax) (per tensor), sw[d] the same over
//   column d of w, and q = clamp(rint(v / s), -qmax, qmax) (IEEE division).
//
// Two s8 planes (8-bit operands).  Each quantized value q in [-255, 255] is
// split as q = 16 h + l with h = q >> 4 in [-16, 15] and l = q & 15 in
// [0, 15]; both fit s8.  A chunk's psum is then
//     sum qx qw = 256 sum hx hw + 16 sum (hx lw + lx hw) + sum lx lw,
// three s32 sums of four mma products (the two cross products share one
// accumulator).  Each is exact: |hx hw| <= 256, |hx lw + lx hw| <= 480 and
// lx lw <= 225, so over N <= 258 positions every sum and the combination
// 256 a + 16 b + c stay far inside s32.  The combined psum is the exact
// integer sum qx qw, |psum| <= N * 255^2 < 2^24, so one __int2float_rn per
// chunk gives the reference's float32 chunk dot product, which is that
// same integer (every partial sum of integers below 2^24 is exact in
// float32, in any order).  No float rounding of a tensor-core product or
// sum is relied on (PTX does not specify how an MMA rounds its float32
// accumulation; s8 -> s32 is exact).
//
// Bound on this card.  At the main path's shapes (K <= 144, D <= 64; and
// the photonic LM's K 768-1536, D 768-3352) a GEMM does 2*K*D operations
// for every row of x it reads, below the card's operation-per-byte balance
// at int8 rates, so the least time is bytes / bandwidth: x, w and the
// output once (plus the noise when it is on).  For 8-bit operands the
// least time counts 2 M K D operations at the bf16 rate (an 8-bit integer
// is exact in bf16); this design does four s8 products for each, so its
// own floor is twice that.  What the designs do about it:
//   * s8 route: quantize and rescale run inside the kernels (the unfused
//     route makes ~16 elementwise passes over x, w and the output); the
//     tile's height is chosen so that a GEMM launches at least 2 x 132
//     blocks where M allows; w is quantized once and copied into shared
//     memory with cp.async, the next piece while this one is multiplied,
//     and so are x's quantized planes where they were written once; the
//     chunk sums stay in registers.
//   * float32 body: one block owns an output tile as wide as D (up to 64
//     columns), so every row of xq is read from device memory once; the
//     chunk loop runs inside the block and the BPCA accumulator stays in
//     registers; ragged M, D and K edges are masked in the loads.
//
// Numerics: every rounding of the reference is kept as a separate IEEE
// float operation (__fmul_rn / __fadd_rn / __fdiv_rn, rintf = round half to
// even, and the file is built with --fmad=false), so both routes equal the
// plain PyTorch version bit for bit wherever the integer chunk psums stay
// below 2^24.  The s8 route's s32 chunk sums are exact; converted once to
// float32 (__int2float_rn) they are the reference's float32 chunk dot
// products, which are exact integers below 2^24.  Inside a chunk the float32
// body accumulates with fmaf: integer products and sums below 2^24 are exact
// in any order and with or without fusion.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
// The fused s8 route (one s8 plane for bits <= 7, two for 8 bits).
// ---------------------------------------------------------------------------
constexpr int kColGroup = 32;       // w columns per absmax block
constexpr int kMaxWarps = 4;        // GEMM block: 1, 2 or 4 row warps
constexpr int kWarpCols = 64;       // a warp's columns at most
constexpr int kItemsInFlight = 8;   // x words a thread loads at once
constexpr int kSlotPad = 16;        // bytes past each staged row (below)
constexpr int kQuantXThreads = 256;
constexpr int kSmallThreads = 256;  // small-chunk kernel: threads a block
constexpr int kSmallStepK = 64;     // its K positions staged at once
constexpr int kSmallMaxN = 8;       // its longest chunk (taom_gemm.SMALL_N)

// How the GEMM kernel gets x's s8 planes: quantized from device memory
// into shared memory as each piece is needed (kXLoad), or copied in a
// piece ahead with cp.async from the planes taom_gemm_quant_x_kernel wrote
// (kXStaged).
enum XMode { kXLoad = 0, kXStaged = 1 };

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

// The s8 plane bytes of a quantized value: P = 1, q itself (|q| <= 127);
// P = 2, h = q >> 4 in [-16, 15] (plane 0) and l = q & 15 in [0, 15]
// (plane 1), q = 16 h + l.
template <int P>
__device__ __forceinline__ void plane_bytes(int q, uint32_t (&b)[P]) {
  if constexpr (P == 1) {
    b[0] = static_cast<uint32_t>(q) & 0xffu;
  } else {
    b[0] = static_cast<uint32_t>(q >> 4) & 0xffu;
    b[1] = static_cast<uint32_t>(q) & 0xfu;
  }
}

// Four quantized values as the s8 bytes of one 32-bit word a plane (v[0]
// lowest).
template <int P>
__device__ __forceinline__ void quant_words(const float (&v)[4],
                                            const Scale& sc, int qmax,
                                            uint32_t (&word)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) word[p] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b[P];
    plane_bytes<P>(quant_int(v[j], sc, qmax), b);
#pragma unroll
    for (int p = 0; p < P; ++p) word[p] |= b[p] << (8 * j);
  }
}

// Where K position kk lies in the staged layout: chunk c = kk / n is cut
// into pieces of `slot` positions (ppc pieces a chunk), and piece i of
// chunk c is stored at bytes [(c * ppc + i) * slot, + slot) of the row.
__device__ __forceinline__ int staged_pos(int kk, int n, int slot, int ppc) {
  const int c = kk / n;
  const int within = kk - c * n;
  const int piece = within / slot;
  return (c * ppc + piece) * slot + (within - piece * slot);
}

// max |partials[i]| over the block, then x's scale max(., eps) * inv_qmax,
// as every block of the route computes it.  red: one float a warp.
__device__ __forceinline__ float x_scale(const float* partials,
                                         int n_partials, float eps,
                                         float inv_qmax, float* red,
                                         float* out) {
  const int tid = threadIdx.x;
  float mx = 0.0f;
#pragma unroll 8
  for (int i = tid; i < n_partials; i += blockDim.x)
    mx = nan_max(mx, partials[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i)
      m = nan_max(m, red[i]);
    *out = __fmul_rn(nan_max(m, eps), inv_qmax);
  }
  __syncthreads();
  return *out;
}

// x as a convolution's windows (implicit im2col): x is the NHWC input
// (images, h, w, c) and GEMM row r = (b, oy, ox), K position kk = (i * kw +
// j) * c + ch is x[b, oy * stride + i - top, ox * stride + j - left, ch],
// zero outside the image: the element of the im2col matrix (K ordered
// window-position-major, channel-minor).  For the |max|, the positions some
// window covers along an axis: t < count stands for (t / run) * period +
// t % run - off, skipped outside [0, size) (taom_gemm.covered_axis).
struct Windows {
  int on;                 // 0: x is the (M, K) matrix itself
  int images, h, w, c, kh, kw, stride, top, left, oh, ow;
  int ycount, yrun, yperiod, yoff, xcount, xrun, xperiod, xoff;
  int full;               // every pixel is covered: x is reduced flat
};

// Blocks [0, n_xblocks) write partial maxima of |x| to partials (with
// windows that leave pixels out, over the covered pixels only: the zeros
// of the padding never raise a |max|).  The
// others each own 32 columns of w: they write the columns' scales
// sw[d] = max(max_k |w[k, d]|, eps) * inv_qmax and the quantized columns
// as P s8 planes of (D, kp) bytes, w_plane bytes apart, in the GEMM's
// staged layout (staged_pos, zeros past each chunk's end), through a
// transposing tile in shared memory so that reads and writes are
// coalesced.  No atomics, no memset.
template <typename XT, typename WT, int kAbsThreads, int P>
__global__ void __launch_bounds__(kAbsThreads)
taom_gemm_absmax_kernel(const XT* __restrict__ x, long long nx, int x_vec,
                        const WT* __restrict__ w, int k, int d, int n,
                        int n_chunks, int slot, int kp, int n_xblocks,
                        float* __restrict__ partials, float* __restrict__ sw,
                        unsigned char* __restrict__ wq, long long w_plane,
                        float eps, float inv_qmax, float qmax,
                        const Windows g) {
  constexpr int kRowGroups = kAbsThreads / kColGroup;
  constexpr int kPerThread = 8;
  constexpr int kKTile = kPerThread * kRowGroups;   // K rows per w tile
  // q itself: a byte for one plane, a short for two.
  using TileT = typename std::conditional<P == 1, unsigned char,
                                          short>::type;
  __shared__ float red[kAbsThreads];
  __shared__ TileT tile[kColGroup][kKTile + 1];
  const int tid = threadIdx.x;
  float mx = 0.0f;
  if (static_cast<int>(blockIdx.x) < n_xblocks) {
    const long long first =
        static_cast<long long>(blockIdx.x) * kAbsThreads + tid;
    const long long stride = static_cast<long long>(n_xblocks) * kAbsThreads;
    constexpr int V = Vec<XT>::n;
    if (g.on && !g.full) {
      // A block a covered input row (image-major) at a time, its threads
      // over the row's covered pixels and channels: a 16-byte vector an
      // item where a pixel holds whole vectors.
      const int per = x_vec && g.c % V == 0 ? V : 1;
      const int items_px = g.c / per;
      const int row_items = g.xcount * items_px;
      for (int u = blockIdx.x; u < g.images * g.ycount; u += n_xblocks) {
        const int b = u / g.ycount;
        const int ty = u - b * g.ycount;
        const int y = ty / g.yrun * g.yperiod + ty % g.yrun - g.yoff;
        if (y < 0 || y >= g.h) continue;
        const XT* row =
            x + (static_cast<long long>(b) * g.h + y) * g.w * g.c;
        for (int it = tid; it < row_items; it += kAbsThreads) {
          const int tx = it / items_px;
          const int xx = tx / g.xrun * g.xperiod + tx % g.xrun - g.xoff;
          if (xx < 0 || xx >= g.w) continue;
          const XT* p = row + static_cast<long long>(xx) * g.c +
                        (it - tx * items_px) * per;
          if (per == V) {
            float v[V];
            ld_vec(p, v);
#pragma unroll
            for (int j = 0; j < V; ++j) mx = nan_max(mx, fabsf(v[j]));
          } else {
            mx = nan_max(mx, fabsf(ld_elem(p)));
          }
        }
      }
    } else {
      long long done = 0;
      if (x_vec) {
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
    }
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
          static_cast<TileT>(quant_int(v[u], sc, iqmax));
    __syncthreads();
    // Write it out column by column, a byte a thread and plane.
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = tid + u * kAbsThreads;
      const int c = i / kKTile;
      const int kk = k0 + i % kKTile;
      if (c0 + c < d && kk < k) {
        uint32_t b[P];
        plane_bytes<P>(static_cast<int>(tile[c][kk - k0]), b);
        unsigned char* dst = wq + static_cast<long long>(c0 + c) * kp +
                             staged_pos(kk, n, slot, ppc);
#pragma unroll
        for (int p = 0; p < P; ++p)
          dst[p * w_plane] = static_cast<unsigned char>(b[p]);
      }
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
    for (int p = clen - last * slot; p < slot; ++p)
#pragma unroll
      for (int pl = 0; pl < P; ++pl) dst[pl * w_plane + p] = 0;
  }
}

// x quantized once into P s8 planes of (M, kp) bytes, x_plane bytes apart,
// in the staged layout w's planes have (zeros past each chunk's end): for a
// GEMM of several column tiles, which then copy x's pieces in with
// cp.async instead of each quantizing its own copy of x's rows.  Every
// block reduces the partial maxima to x's scale as the GEMM does.
//
// WIN: x is a convolution's input read as its windows (Windows).  Each
// block first tabulates what every staged position of a row holds
// (window_entry), in kp ints of shared memory; then each warp takes an
// output pixel at a time, its lanes a word (4 positions) each, so that a
// row costs two divisions and a position a table read, two bounds checks
// and a load (neighbouring pixels' windows overlap, and the input is read
// again from the caches).
constexpr unsigned kNoEntry = 0xffffffffu;   // past its chunk's end

// Staged position p of a row: (i << 28) | (j << 24) | ((i w + j) c + ch)
// for window position (i, j), channel ch (kh, kw <= 15 and the offset
// below 2^24: taom_gemm.window_plan), or kNoEntry.
__device__ __forceinline__ unsigned window_entry(int p, int n, int k,
                                                 int slot, int ppc,
                                                 const Windows& g) {
  const int piece = p / slot;
  const int c = piece / ppc;
  const int within = (piece - c * ppc) * slot + (p - piece * slot);
  if (within >= min(n, k - c * n)) return kNoEntry;
  const int kk = c * n + within;
  const int q = kk / g.c;
  const int i = q / g.kw;
  const int j = q - i * g.kw;
  return (static_cast<unsigned>(i) << 28) | (static_cast<unsigned>(j) << 24) |
         static_cast<unsigned>((i * g.w + j) * g.c + kk - q * g.c);
}

template <typename XT, int P, bool WIN>
__global__ void __launch_bounds__(kQuantXThreads)
taom_gemm_quant_x_kernel(const XT* __restrict__ x, int m, int k, int n,
                         int slot, int kp, const float* __restrict__ partials,
                         int n_partials, float eps, float inv_qmax,
                         float qmax, unsigned char* __restrict__ xq,
                         long long x_plane, const Windows g) {
  __shared__ float red[kQuantXThreads / 32];
  __shared__ float sx_s;
  const Scale sc = make_scale(x_scale(partials, n_partials, eps, inv_qmax,
                                      red, &sx_s));
  const int iqmax = static_cast<int>(qmax);
  const int ppc = (n + slot - 1) / slot;
  const int wpr = kp >> 2;                       // words a row
  if constexpr (WIN) {
    extern __shared__ __align__(16) unsigned table[];   // kp entries
    for (int p = threadIdx.x; p < kp; p += blockDim.x)
      table[p] = window_entry(p, n, k, slot, ppc, g);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (blockDim.x >> 5);
    const int pix = g.oh * g.ow;
    for (int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); r < m;
         r += warps) {
      const int b = r / pix;
      const int o = r - b * pix;
      const int oy = o / g.ow;
      const int y0 = oy * g.stride - g.top;
      const int x0 = (o - oy * g.ow) * g.stride - g.left;
      // The window's first element (maybe outside the image: only offsets
      // that land inside are read).
      const long long base =
          ((static_cast<long long>(b) * g.h + y0) * g.w + x0) * g.c;
      unsigned char* dst = xq + static_cast<long long>(r) * kp;
      for (int wd = lane; wd < wpr; wd += 32) {
        const uint4 e4 = reinterpret_cast<const uint4*>(table)[wd];
        const unsigned es[4] = {e4.x, e4.y, e4.z, e4.w};
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned e = es[j];
          const int y = y0 + static_cast<int>(e >> 28);
          const int xx = x0 + static_cast<int>((e >> 24) & 15u);
          const bool in =
              e != kNoEntry &&
              static_cast<unsigned>(y) < static_cast<unsigned>(g.h) &&
              static_cast<unsigned>(xx) < static_cast<unsigned>(g.w);
          v[j] = in ? ld_elem(x + (base + (e & 0xffffffu))) : 0.0f;
        }
        uint32_t word[P];
        quant_words<P>(v, sc, iqmax, word);
#pragma unroll
        for (int pl = 0; pl < P; ++pl)
          *reinterpret_cast<uint32_t*>(dst + pl * x_plane + 4 * wd) =
              word[pl];
      }
    }
    return;
  }
  const long long words = static_cast<long long>(m) * wpr;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < words; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / wpr;
    const int pos = 4 * static_cast<int>(i - r * wpr);   // staged position
    const int piece = pos / slot;
    const int c = piece / ppc;
    const int within = (piece - c * ppc) * slot + (pos - piece * slot);
    const int clen = min(n, k - c * n);
    const XT* src = x + r * k + c * n + within;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = within + j < clen ? ld_elem(src + j) : 0.0f;
    uint32_t word[P];
    quant_words<P>(v, sc, iqmax, word);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint32_t*>(xq + p * x_plane + r * kp + pos) =
          word[p];
  }
}

struct Int8Args {
  const void* x;               // (M, K) XT, row-major
  const float* noise;          // see the header, or null
  void* out;                   // (M, D) XT
  const unsigned char* wq;     // P planes of (D, kp) s8: w, staged layout
  const unsigned char* xq;     // kXStaged: P planes of (M, kp) s8: x
  const float* partials;       // n_partials partial maxima of |x|
  const float* sw;             // (D,) column scales of w
  long long w_plane, x_plane;  // bytes between two planes
  int planes;                  // s8 planes an operand, 1 or 2
  int m, k, d, n, n_chunks, chunk_adc, n_partials, kp;
  int slot;                    // staged K positions, a multiple of 32
  float coef, inv_step, step, hi, qmax, inv_qmax, eps;
};

// Stage rows [m0, m0 + rows) of x at K positions [start, start + len) into
// the P planes xs[p * plane + r * stride + pos] as s8, a 32-bit word (4
// positions) an item and kItemsInFlight items a thread at once; zeros past
// len (up to slot) and past M.
template <typename T, int P>
__device__ __forceinline__ void stage_x(unsigned char* xs, int plane,
                                        const T* x, long long m0, int rows,
                                        int m, int k, int start, int len,
                                        int slot, int stride,
                                        const Scale& sc, int qmax) {
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
      uint32_t word[P];
      quant_words<P>(v[u], sc, qmax, word);
#pragma unroll
      for (int pl = 0; pl < P; ++pl)
        *reinterpret_cast<uint32_t*>(xs + pl * plane + r * stride + p) =
            word[pl];
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

// Start the copy of piece `piece` of staged rows [r0, r0 + rows) of P
// planes (src_plane bytes apart; a row kp bytes) into dst[p * dst_plane +
// r * stride + pos] (k-contiguous: mma's .row A and .col B layouts), 16
// bytes a cp.async.  Rows past `rows` are never written (the caller zeroes
// them once).  The pieces are already padded with zeros.
template <int P>
__device__ __forceinline__ void copy_staged_async(
    unsigned char* dst, int dst_plane, const unsigned char* src,
    long long src_plane, long long r0, int rows, int kp, int piece,
    int slot, int stride) {
  const int vpr = slot >> 4;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
      const int r = i / vpr;
      const int q = i - r * vpr;
      cp_async16(dst + p * dst_plane + r * stride + 16 * q,
                 src + p * src_plane + (r0 + r) * kp + piece * slot +
                     16 * q);
    }
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

// Shared memory of one block of 16 * warps rows: the s8 x tile (two with
// kXStaged) and two s8 w tiles of tile_d columns, each P planes.
template <int P>
int int8_smem_bytes(int tile_d, int warps, int mode, int slot) {
  const int bm = 16 * warps;
  const int stride = slot + kSlotPad;
  return P * ((mode == kXStaged ? 2 : 1) * bm + 2 * tile_d) * stride;
}

// One block computes a (16 * warps) x BD output tile with warps x WN
// warps (WN = BD / 64 for BD 128, else 1): warp (i, j) owns rows 16 i ..
// 16 i + 15 and columns j * BD / WN .. of it, as BD / WN / 8 mma tiles.  K is
// walked piece by piece (each chunk cut into pieces of at most `slot`
// positions): the next piece's w (and, with kXStaged, its x planes) is
// copied with cp.async into the other of two buffers while this piece is
// multiplied on the tensor cores in s32; at a chunk's end the s32 sums are
// combined, converted and the policy applied.  With kXLoad x is loaded and
// quantized straight from device memory, piece by piece.  Row stride slot
// + 16 bytes (= 16 mod 32) puts the 8 rows of a fragment load on 8
// distinct groups of 4 banks.
//
// P = 1: one s8 plane, one mma a tile.  P = 2: planes h and l (header);
// four mma a tile into three sums, hh, hl + lh and ll, combined at the
// chunk's end as 256 hh + 16 (hl + lh) + ll.
//
// Fragments of m16n8k32 (PTX ISA; g = lane / 4, t = lane % 4):
//   A (16 x 32 s8, row): a[0] = row g,   k 4t..4t+3;  a[1] = row g+8, same k;
//                        a[2] = row g,   k 16+4t..;   a[3] = row g+8, same k
//   B (32 x 8 s8, col):  b[0] = col g,   k 4t..4t+3;  b[1] = col g, k 16+4t..
//   C (16 x 8 s32):      c[0], c[1] = row g,   cols 2t, 2t+1;
//                        c[2], c[3] = row g+8, cols 2t, 2t+1
template <typename XT, int BD, int MODE, int P>
__global__ void __launch_bounds__(32 * kMaxWarps * 2)
taom_gemm_int8_kernel(const Int8Args a) {
  constexpr int WN = BD > kWarpCols ? BD / kWarpCols : 1;
  constexpr int NT = BD / WN / 8;
  constexpr int S = 2 * P - 1;            // s32 sums a tile
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
  const int xplane = bm * stride;        // shared bytes of one plane
  const int wplane = BD * stride;
  // The two buffers of each tile are addressed by arithmetic on one base
  // (an array of the two pointers indexed at run time would go to local
  // memory and turn every fragment load into a generic one).
  unsigned char* const xs0 = smem;
  const int xs_buf = MODE == kXStaged ? P * xplane : 0;
  unsigned char* const w0 = xs0 + (MODE == kXStaged ? 2 : 1) * P * xplane;
  const int ws_buf = P * wplane;
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int d0 = blockIdx.y * BD;
  const int ppc = (a.n + a.slot - 1) / a.slot;
  const int wcols = min(BD, a.d - d0);
  const int xrows = static_cast<int>(min(static_cast<long long>(bm),
                                         a.m - m0));

  // Zero the copied tiles once in a tile that passes D or M: columns past
  // D and rows past M are never copied in.
  if (wcols < BD || (MODE == kXStaged && xrows < bm)) {
    unsigned char* zero0 = MODE == kXStaged ? xs0 : w0;
    const int zero_bytes = MODE == kXStaged ? 2 * P * (xplane + wplane)
                                            : 2 * P * wplane;
    for (int i = tid; i < zero_bytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(zero0)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  // The first piece's copies fly while the scales are reduced.
  copy_staged_async<P>(w0, wplane, a.wq, a.w_plane, d0, wcols, a.kp, 0,
                       a.slot, stride);
  if (MODE == kXStaged)
    copy_staged_async<P>(xs0, xplane, a.xq, a.x_plane, m0, xrows, a.kp, 0,
                         a.slot, stride);
  cp_async_commit();

  // x's scale from the partial maxima; the tile's column scales.
  for (int i = tid; i < BD; i += blockDim.x)
    sw_s[i] = d0 + i < a.d ? a.sw[d0 + i] : 0.0f;
  const float sx = x_scale(a.partials, a.n_partials, a.eps, a.inv_qmax, red,
                           &sx_s);
  const Scale sc = make_scale(sx);
  const int iqmax = static_cast<int>(a.qmax);

  float carry[NT][4];
  int ps[S][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      carry[j][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) ps[s][j][e] = 0;
    }

  const int arow = (wm * 16 + g) * stride + 4 * t;
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
      const int npiece = nc * ppc + np0 / a.slot;
      const int nb = buf ^ 1;
      copy_staged_async<P>(w0 + nb * ws_buf, wplane, a.wq, a.w_plane, d0,
                           wcols, a.kp, npiece, a.slot, stride);
      if (MODE == kXStaged)
        copy_staged_async<P>(xs0 + nb * xs_buf, xplane, a.xq, a.x_plane, m0,
                             xrows, a.kp, npiece, a.slot, stride);
    }
    cp_async_commit();
    if (MODE == kXLoad)
      stage_x<XT, P>(xs0, xplane, x, m0, bm, a.m, a.k, cs + p0, len, a.slot,
                     stride, sc, iqmax);
    cp_async_wait_one();
    __syncthreads();
    const unsigned char* xa = xs0 + buf * xs_buf + arow;
    const unsigned char* wb = w0 + buf * ws_buf + (wn + g) * stride + 4 * t;
    const int ksteps = (len + 31) / 32;
#pragma unroll 1
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t af[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const unsigned char* r = xa + p * xplane + kk * 32;
        af[p][0] = *reinterpret_cast<const uint32_t*>(r);
        af[p][1] = *reinterpret_cast<const uint32_t*>(r + 8 * stride);
        af[p][2] = *reinterpret_cast<const uint32_t*>(r + 16);
        af[p][3] = *reinterpret_cast<const uint32_t*>(r + 8 * stride + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bf[P][2];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const unsigned char* col = wb + p * wplane + j * 8 * stride +
                                     kk * 32;
          bf[p][0] = *reinterpret_cast<const uint32_t*>(col);
          bf[p][1] = *reinterpret_cast<const uint32_t*>(col + 16);
        }
        if constexpr (P == 1) {
          mma_s8(ps[0][j], af[0], bf[0]);
        } else {
          mma_s8(ps[0][j], af[0], bf[0]);
          mma_s8(ps[1][j], af[0], bf[1]);
          mma_s8(ps[1][j], af[1], bf[0]);
          mma_s8(ps[2][j], af[1], bf[1]);
        }
      }
    }
    __syncthreads();

    if (nc != c) {   // the chunk's last piece: combine, convert, policy
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int sum = ps[0][j][e];
          if constexpr (P == 2)
            sum = sum * 256 + ps[1][j][e] * 16 + ps[S - 1][j][e];
#pragma unroll
          for (int s = 0; s < S; ++s) ps[s][j][e] = 0;
          float v = __int2float_rn(sum);
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

  // The epilogue, in one straight-line copy per policy (the branches on
  // the policy and the noise hoisted out of the loop).
  XT* __restrict__ out = static_cast<XT*>(a.out);
  auto store = [&](const bool carry_adc, const bool carry_noise) {
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
        if (carry_adc) {
          if (carry_noise)
            v = __fadd_rn(v, __fmul_rn(a.coef, a.noise[o]));
          v = adc_round(v, a.inv_step, a.step, a.hi);
        }
        st_elem(out + o, __fmul_rn(v, __fmul_rn(sx, sw_s[col])));
      }
  };
  if (a.chunk_adc)
    store(false, false);
  else if (a.noise != nullptr)
    store(true, true);
  else
    store(true, false);
}

// Small chunks on the CUDA cores.  Where a chunk holds few K positions
// (Table 4's N 2 and N 1), a 32-deep tensor-core slot a chunk wastes most
// of its products, and walking K a chunk at a time through the pipeline
// above is bound by latency.  Here each thread owns column d0 + tid % TW
// of R rows (tid / TW + i * 256 / TW), kSmallStepK positions of whole
// chunks (at least one) are staged at once as quantized ints (a row's
// stride one int past the step, so the rows a warp reads fall in distinct
// banks), and each
// chunk's N products are summed in s32 (exact: |psum| <= N qmax^2 < 2^24,
// converted once); every noise element is read once, consecutive threads
// on consecutive columns.  w comes from the absmax kernel's planes in the
// compact layout (slot = N: column d's position kk at byte d * kp + kk).
template <typename XT, int TW, int R>
__global__ void __launch_bounds__(kSmallThreads)
taom_gemm_small_kernel(const Int8Args a) {
  constexpr int RP = kSmallThreads / TW;      // rows a pass
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sw_s[TW];
  __shared__ float red[kSmallThreads / 32];
  __shared__ float sx_s;
  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int tid = threadIdx.x;
  const int dd = tid % TW;
  const int rr = tid / TW;
  const int bm = RP * R;
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int d0 = blockIdx.y * TW;
  const int gd = d0 + dd;
  const int n = a.n;
  const int chunks_a_step = max(1, kSmallStepK / n);
  const int step = chunks_a_step * n;          // K positions a step
  const int xstride = step + 1;
  int* xs = reinterpret_cast<int*>(smem);      // [bm][xstride]
  int* ws = xs + bm * xstride;                 // [step][TW]

  if (tid < TW) sw_s[tid] = gd < a.d ? a.sw[gd] : 0.0f;
  const float sx = x_scale(a.partials, a.n_partials, a.eps, a.inv_qmax, red,
                           &sx_s);
  const Scale sc = make_scale(sx);
  const int iqmax = static_cast<int>(a.qmax);

  float carry[R];
#pragma unroll
  for (int i = 0; i < R; ++i) carry[i] = 0.0f;
  for (int c0 = 0; c0 < a.n_chunks; c0 += chunks_a_step) {
    const int k0 = c0 * n;
    const int len = min(step, a.k - k0);
    for (int i = tid; i < bm * step; i += kSmallThreads) {
      const int r = i / step;
      const int p = i - r * step;
      const long long gm = m0 + r;
      const float v =
          (gm < a.m && p < len) ? ld_elem(x + gm * a.k + k0 + p) : 0.0f;
      xs[r * xstride + p] = quant_int(v, sc, iqmax);
    }
    for (int i = tid; i < TW * step; i += kSmallThreads) {
      const int c = i / step;
      const int p = i - c * step;
      int q = 0;
      if (d0 + c < a.d && p < len) {
        const unsigned char* src =
            a.wq + static_cast<long long>(d0 + c) * a.kp + k0 + p;
        q = static_cast<signed char>(src[0]);
        if (a.planes == 2) q = q * 16 + src[a.w_plane];
      }
      ws[p * TW + c] = q;
    }
    __syncthreads();
    const int chunks = min(chunks_a_step, a.n_chunks - c0);
#pragma unroll 4
    for (int g = 0; g < chunks; ++g) {
      const int c = c0 + g;
      const int clen = min(n, a.k - c * n);
      int ps[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ps[i] = 0;
      for (int j = 0; j < clen; ++j) {
        const int p = g * n + j;
        const int wv = ws[p * TW + dd];
#pragma unroll
        for (int i = 0; i < R; ++i)
          ps[i] += xs[(rr + i * RP) * xstride + p] * wv;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float v = __int2float_rn(ps[i]);
        if (a.chunk_adc) {
          const long long gm = m0 + rr + i * RP;
          if (a.noise != nullptr && gm < a.m && gd < a.d) {
            const float z =
                a.noise[(static_cast<long long>(c) * a.m + gm) * a.d + gd];
            v = __fadd_rn(v, __fmul_rn(a.coef, z));
          }
          v = adc_round(v, a.inv_step, a.step, a.hi);
        }
        carry[i] = __fadd_rn(carry[i], v);
      }
    }
    __syncthreads();
  }

  XT* __restrict__ out = static_cast<XT*>(a.out);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long gm = m0 + rr + i * RP;
    if (gm >= a.m || gd >= a.d) continue;
    const long long o = gm * a.d + gd;
    float v = carry[i];
    if (!a.chunk_adc) {
      if (a.noise != nullptr) v = __fadd_rn(v, __fmul_rn(a.coef, a.noise[o]));
      v = adc_round(v, a.inv_step, a.step, a.hi);
    }
    st_elem(out + o, __fmul_rn(v, __fmul_rn(sx, sw_s[dd])));
  }
}

template <typename XT, int TW, int R>
cudaError_t launch_small(const Int8Args& a, cudaStream_t stream) {
  const int bm = kSmallThreads / TW * R;
  const int step = (a.n < kSmallStepK ? kSmallStepK / a.n : 1) * a.n;
  const int smem =
      (bm * (step + 1) + step * TW) * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        taom_gemm_small_kernel<XT, TW, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.m + bm - 1) / bm, (a.d + TW - 1) / TW);
  taom_gemm_small_kernel<XT, TW, R><<<grid, kSmallThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT, int TW>
cudaError_t launch_small(const Int8Args& a, int rows, cudaStream_t stream) {
  return rows == 2 ? launch_small<XT, TW, 2>(a, stream)
                   : launch_small<XT, TW, 1>(a, stream);
}

template <typename XT, int BD, int MODE, int P>
cudaError_t launch_int8(const Int8Args& a, int warps, cudaStream_t stream) {
  constexpr int WN = BD > kWarpCols ? BD / kWarpCols : 1;
  const int bm = 16 * warps;
  const dim3 grid((a.m + bm - 1) / bm, (a.d + BD - 1) / BD);
  const int smem = int8_smem_bytes<P>(BD, warps, MODE, a.slot);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        taom_gemm_int8_kernel<XT, BD, MODE, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  taom_gemm_int8_kernel<XT, BD, MODE, P>
      <<<grid, 32 * warps * WN, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT, int BD, int P>
cudaError_t launch_int8_mode(const Int8Args& a, int warps, int mode,
                             cudaStream_t stream) {
  return mode == kXStaged
             ? launch_int8<XT, BD, kXStaged, P>(a, warps, stream)
             : launch_int8<XT, BD, kXLoad, P>(a, warps, stream);
}

template <typename XT, int P>
cudaError_t launch_int8_tile(const Int8Args& a, int tile_d, int warps,
                             int mode, cudaStream_t stream) {
  switch (tile_d) {
    case 8: return launch_int8_mode<XT, 8, P>(a, warps, mode, stream);
    case 16: return launch_int8_mode<XT, 16, P>(a, warps, mode, stream);
    case 32: return launch_int8_mode<XT, 32, P>(a, warps, mode, stream);
    case 64: return launch_int8_mode<XT, 64, P>(a, warps, mode, stream);
    case 128: return launch_int8_mode<XT, 128, P>(a, warps, mode, stream);
    default: return cudaErrorInvalidValue;
  }
}

long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }

template <typename XT, typename WT, int P>
cudaError_t launch_fused(Int8Args a, const WT* w, unsigned char* scratch,
                         int tile_d, int height, int n_xblocks, int x_vec,
                         int x_once, int small, const Windows& g,
                         cudaStream_t stream) {
  // scratch: w's planes, x's planes (x_once), partials, column scales;
  // each region starts on 16 bytes.
  a.w_plane = static_cast<long long>(a.d) * a.kp;
  a.x_plane = static_cast<long long>(a.m) * a.kp;
  unsigned char* wq = scratch;
  unsigned char* xq = wq + round16(P * a.w_plane);
  float* partials = reinterpret_cast<float*>(
      xq + (x_once ? round16(P * a.x_plane) : 0));
  float* sw = partials + n_xblocks;
  const int col_blocks = (a.d + kColGroup - 1) / kColGroup;
  // Long columns of w take 1024 threads (32 rows of a column at once), the
  // short ones of the CNN's GEMMs 256.
  const XT* x = static_cast<const XT*>(a.x);
  const long long nx = g.on ? static_cast<long long>(g.images) * g.h * g.w *
                                  g.c
                            : static_cast<long long>(a.m) * a.k;
  if (a.k > 256) {
    taom_gemm_absmax_kernel<XT, WT, 1024, P>
        <<<n_xblocks + col_blocks, 1024, 0, stream>>>(
            x, nx, x_vec, w, a.k, a.d, a.n, a.n_chunks, a.slot, a.kp,
            n_xblocks, partials, sw, wq, a.w_plane, a.eps, a.inv_qmax,
            a.qmax, g);
  } else {
    taom_gemm_absmax_kernel<XT, WT, 256, P>
        <<<n_xblocks + col_blocks, 256, 0, stream>>>(
            x, nx, x_vec, w, a.k, a.d, a.n, a.n_chunks, a.slot, a.kp,
            n_xblocks, partials, sw, wq, a.w_plane, a.eps, a.inv_qmax,
            a.qmax, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.wq = wq;
  a.partials = partials;
  a.n_partials = n_xblocks;
  a.sw = sw;
  a.planes = P;
  if (small) {
    switch (tile_d) {
      case 8: return launch_small<XT, 8>(a, height, stream);
      case 16: return launch_small<XT, 16>(a, height, stream);
      case 32: return launch_small<XT, 32>(a, height, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  const int warps = height;
  int mode = kXLoad;
  if (x_once) {
    const long long words = a.x_plane / 4;
    const long long want = (words + kQuantXThreads - 1) / kQuantXThreads;
    if (g.on) {
      // A warp a row; a block's table of kp ints (at most 48 KiB,
      // taom_gemm.window_plan).
      const int rows = kQuantXThreads / 32;
      const int blocks = (a.m + rows - 1) / rows;
      taom_gemm_quant_x_kernel<XT, P, true>
          <<<blocks < 132 * 8 ? blocks : 132 * 8, kQuantXThreads,
             a.kp * static_cast<int>(sizeof(unsigned)), stream>>>(
              x, a.m, a.k, a.n, a.slot, a.kp, partials, n_xblocks, a.eps,
              a.inv_qmax, a.qmax, xq, a.x_plane, g);
    } else {
      const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
      taom_gemm_quant_x_kernel<XT, P, false>
          <<<blocks, kQuantXThreads, 0, stream>>>(
              x, a.m, a.k, a.n, a.slot, a.kp, partials, n_xblocks, a.eps,
              a.inv_qmax, a.qmax, xq, a.x_plane, g);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.xq = xq;
    mode = kXStaged;
  }
  return launch_int8_tile<XT, P>(a, tile_d, warps, mode, stream);
}

template <typename XT, typename WT>
cudaError_t launch_planes(const Int8Args& a, const WT* w,
                          unsigned char* scratch, int planes, int tile_d,
                          int height, int n_xblocks, int x_vec, int x_once,
                          int small, const Windows& g, cudaStream_t stream) {
  return planes == 2
             ? launch_fused<XT, WT, 2>(a, w, scratch, tile_d, height,
                                       n_xblocks, x_vec, x_once, small, g,
                                       stream)
             : launch_fused<XT, WT, 1>(a, w, scratch, tile_d, height,
                                       n_xblocks, x_vec, x_once, small, g,
                                       stream);
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

// Plain C entry point of the fused s8 route (loaded with ctypes).  x and
// out are float32 (x_bf16 = 0) or bfloat16 (1); w float32 or bfloat16
// (w_bf16).  planes: 1 (qmax <= 127) or 2 (qmax <= 255, n * qmax^2 <
// 2^24).  scratch holds planes * d * kp bytes of quantized w (kp = n_chunks
// * ceil(n / slot) * slot), then with x_once planes * m * kp bytes of
// quantized x, then n_xblocks + d floats, each region rounded up to 16
// bytes; the wrapper allocates it.
// small = 0, the tensor-core GEMM: tile_d is 8, 16, 32, 64 or 128
// columns; the tile is 16 * height rows high (height: warps, 1, 2 or 4);
// slot is the number of K positions staged at once (a multiple of 32, at
// most 192).  small = 1, the small-chunk kernel on the CUDA cores: tile_d
// is 8, 16 or 32 columns, each thread owns height (1 or 2) rows of one
// column, slot == n (the compact layout) and n <= kSmallMaxN.  x_vec says
// x is 16-byte aligned: the absmax kernel then reads it in 16-byte
// vectors.  x_once (small = 0):
// quantize x once (taom_gemm_quant_x_kernel, a third launch) instead of in
// every column tile.  conv: null, or x is a convolution's NHWC input and
// the GEMM's x its windows (Windows; needs x_once and small = 0): 19 ints,
// images, h, w, c, kh, kw, stride, top, left, oh, ow, then the covered
// positions of each axis (count, run, period, off), rows then columns.
// Returns the first nonzero cudaGetLastError() of the
// launches (and of raising a kernel's shared memory limit), or 0.
extern "C" int taom_gemm_int8(const void* x, const void* w,
                              const float* noise, void* out, void* scratch,
                              int x_bf16, int w_bf16, int m, int k, int d,
                              int n, int n_chunks, int chunk_adc, float coef,
                              float inv_step, float step, float hi,
                              float qmax, float inv_qmax, float eps,
                              int tile_d, int height, int slot,
                              int n_xblocks, int kp, int x_vec, int planes,
                              int x_once, int small, const int* conv,
                              void* stream_ptr) {
  const bool planes_ok = (planes == 1 && qmax <= 127.0f) ||
                         (planes == 2 && qmax <= 255.0f);
  const bool tiles_ok =
      small ? (tile_d == 8 || tile_d == 16 || tile_d == 32) &&
                  (height == 1 || height == 2) && slot == n && !x_once &&
                  n <= kSmallMaxN
            : (tile_d == 8 || tile_d == 16 || tile_d == 32 || tile_d == 64 ||
               tile_d == 128) &&
                  (height == 1 || height == 2 || height == kMaxWarps) &&
                  slot >= 32 && slot % 32 == 0 && slot <= 192;
  if (!planes_ok || !tiles_ok || n_xblocks < 1 ||
      kp != n_chunks * ((n + slot - 1) / slot) * slot) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Windows g{};
  if (conv != nullptr) {
    int* const fields[] = {&g.images, &g.h,       &g.w,      &g.c,
                           &g.kh,     &g.kw,      &g.stride, &g.top,
                           &g.left,   &g.oh,      &g.ow,     &g.ycount,
                           &g.yrun,   &g.yperiod, &g.yoff,   &g.xcount,
                           &g.xrun,   &g.xperiod, &g.xoff};
    for (int i = 0; i < 19; ++i) *fields[i] = conv[i];
    g.on = 1;
    g.full = g.yrun == g.ycount && g.ycount == g.h && g.yoff == 0 &&
             g.xrun == g.xcount && g.xcount == g.w && g.xoff == 0;
    const bool shape_ok =
        g.images > 0 && g.c > 0 && g.oh > 0 && g.ow > 0 && g.kw > 0 &&
        g.yrun > 0 && g.xrun > 0 &&
        static_cast<long long>(g.images) * g.oh * g.ow == m &&
        static_cast<long long>(g.kh) * g.kw * g.c == k;
    if (!shape_ok || !x_once || small)
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
    err = w_bf16 ? launch_planes<bf16, bf16>(a, wb, buf, planes, tile_d,
                                             height, n_xblocks, x_vec,
                                             x_once, small, g, stream)
                 : launch_planes<bf16, float>(a, wf, buf, planes, tile_d,
                                              height, n_xblocks, x_vec,
                                              x_once, small, g, stream);
  } else {
    err = w_bf16 ? launch_planes<float, bf16>(a, wb, buf, planes, tile_d,
                                              height, n_xblocks, x_vec,
                                              x_once, small, g, stream)
                 : launch_planes<float, float>(a, wf, buf, planes, tile_d,
                                               height, n_xblocks, x_vec,
                                               x_once, small, g, stream);
  }
  return static_cast<int>(err);
}
