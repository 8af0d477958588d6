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
// VMEM.  Here a 64-row query tile's m, l and acc live in registers, and
// its owner loops over the 64-row key tiles itself.  Key tiles wholly
// above the diagonal, or wholly before the window of the tile's first
// query row, are skipped: their contribution is exactly 0
// (p = exp(-1e30 - m) = 0, corr = 1) or cancelled (corr = 0), so the
// result does not change.  The TPU kernel cannot skip them.  Blocks are
// issued heaviest query tile first.
//
// Bound on this card: at the served shape (qwen2-0.5b, D 64, S 1000, bf16)
// the causal work is 4 D S(S+1)/2 flops per row against 8 S D bytes, ~250
// flops a byte, about the bf16 tensor cores' balance (989 TFLOP/s over
// 3.35 TB/s = 295) and far above the float32 CUDA cores' (20).  So the
// products have to run on the tensor cores, and the two instances differ:
//
// bfloat16 (flash_attention_fwd_kernel_tc): both products on the bf16
// tensor cores with wgmma, warp-specialised.
//   * S = Q K^T: wgmma m64n64k16, Q (A) and K (B) both from shared memory,
//     both K-major (D is contiguous).  bf16 x bf16 products are exact in
//     float32 and the sum is float32, so only the order of the sum differs
//     from the plain version's; the scale is applied after the dot.
//   * O += P V: P stays float32, as in the reference's kernel (its XLA
//     path rounds P to bf16; its flash kernel does not).  It reaches the
//     tensor cores as two bf16 terms, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), |p - p_hi - p_lo| <= 2^-17 p, each the
//     register A operand of a wgmma against the same V tile (B from shared
//     memory, D contiguous: the transposed, MN-major B).  The P V work
//     doubles (1.5x the function's flops in all); m, l (the sum of the
//     float32 p, kept per lane and added across the row's four lanes at
//     the end), corr and the final divide stay float32 in registers.
//   * A block holds a producer warpgroup and one consumer warpgroup per
//     64-row query tile: two neighbouring tiles of a head at NG <= 2, one
//     above.  K and V stream through a ring of shared-memory stages (4 at
//     NG <= 2, 2 above) that TMA fills from 3-D tensor maps over
//     (D, S, BH): a tile that runs past S zero-fills instead of reading
//     the next head's rows, and D is zero-filled up to a multiple of 64.
//     Completion is signalled on mbarriers ("full" by the copy's bytes,
//     "empty" by every consumer thread, so the consumers share each tile;
//     a consumer passes over the union's tiles it does not need).
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232).  Shared tiles use the 128-byte swizzle, in 64-column atoms
//     of 64 rows x 128 bytes.  A consumer does one tile at a time: Q K^T,
//     wait, softmax, P V, wait (overlapping the next tile's Q K^T with the
//     softmax measured no faster; PERF.md).
//   * TMA needs 16-byte global strides and addresses: with D % 8 != 0 (or
//     a misaligned pointer) the same kernel's producer warpgroup stages
//     the tiles with plain masked loads into the same swizzled layout
//     (fence.proxy.async, then an mbarrier arrive) instead.
//   * D is padded to NG * 64 columns (NG = ceil(D/64) = 1..4); the output
//     accumulator is 64 x NG*64 float32 per consumer (32 NG registers a
//     thread).
//
// float32 (flash_attention_fwd_kernel): unchanged, on the CUDA cores.
// Tensor cores would round float32 operands to TF32, which the float32
// contract forbids, so 67 TFLOP/s bounds it.  One block owns one (bh,
// 64-row query tile) and stages each K and V tile in shared memory as
// float32; the two products run as register-tiled products out of shared
// memory — 256 threads, each holding
// a 4 x 4 tile of scores and a 4-row x 4*NG-column tile of the
// accumulator, reading 16-byte vectors that a half-warp shares or that
// fall on distinct banks (row strides padded by 4 floats); the row
// statistics are reduced with warp shuffles inside a half-warp.  D is
// zero-padded to NG * 64 columns in shared memory; the loads mask rows
// >= S and columns >= D.

#include <cuda.h>           // CUtensorMap and its enums (types only; the
                            // encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // query rows and key rows per tile
constexpr int kLdp = kTile + 4;       // row stride of P
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA ring (see the header)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                 // query rows a consumer owns; keys a tile
constexpr int kAtom = 64;                 // bf16 columns of one 128-byte swizzle atom
constexpr int kAtomBytes = kRows * 128;   // one 64-row x 64-column atom
// setmaxnreg moves registers from the producer warpgroup to the consumers:
// 40 + 2 x 232 = 3 x 168, the launch bound's cap at entry with two
// consumers (65536 / 384); with one, the entry count is the consumer's.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int NG>
struct TcCfg {
  // Consumer warpgroups a block (one 64-row query tile each), sharing the
  // K/V stream; one block an SM.  Above NG = 2 one consumer keeps the
  // whole register file (a 64 x NG*64 accumulator) to itself.
  static constexpr int kConsumers = NG <= 2 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // Shared memory: the Q tiles and the K/V ring, under 227 KB.
  static constexpr int kStages = NG <= 2 ? 4 : 2;
  static constexpr int kTileBytes = NG * kAtomBytes;       // Q, K or V
  static constexpr int kBarriers = 1 + 2 * kStages;
  static constexpr int kSmem = 1024 +
                               kTileBytes * (kConsumers + 2 * kStages) +
                               8 * kBarriers;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A
// phase that never completes (a fault in the pipeline) traps after 2^22
// polls (seconds: a poll may suspend the thread for about a microsecond)
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// K-major (Q, K): SBO = 1024 bytes between 8-row groups, LBO unused.
// MN-major (V): SBO = 1024 bytes between groups of 8 keys, LBO = the next
// 64-column atom (unused at N = 64).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
  "+f"(d[31])
#define REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B^T, A and B (64 x 16) K-major in
// shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B, B (16 x 64) in
// shared memory with its N (D) axis contiguous (transposed, imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC32
#undef REGS32

// p = p_hi + p_lo + e, |e| <= 2^-17 p: both terms bf16, round to nearest;
// p0 in the low half of each register (the lower column).
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte offset of element (r, c) of a 64-row tile in 64-column atoms with
// the 128-byte swizzle, as TMA writes it (16-byte chunk c/8 XOR r%8).
__device__ __forceinline__ int sw128_offset(int r, int c) {
  const int cc = c & (kAtom - 1);
  return (c >> 6) * kAtomBytes + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) +
         ((cc & 7) << 1);
}

// Rows [r0, r0 + 64) of a (S, D) bf16 matrix into a swizzled tile, zero
// where the row is >= S or the column >= D; 128 threads, pt = 0..127.
template <int NG>
__device__ __forceinline__ void stage_plain(
    const __nv_bfloat16* __restrict__ src, uint8_t* dst, int pt, int r0,
    int S, int D) {
  constexpr int cols = NG * kAtom;
  for (int i = pt; i < kRows * cols; i += 128) {
    const int r = i / cols;
    const int c = i - r * cols;
    const int row = r0 + r;
    __nv_bfloat16 x = __ushort_as_bfloat16(0);
    if (row < S && c < D) x = src[(long long)row * D + c];
    *reinterpret_cast<__nv_bfloat16*>(dst + sw128_offset(r, c)) = x;
  }
}

template <int NG, bool TMA>
__global__ void __launch_bounds__(TcCfg<NG>::kThreads, 1)
flash_attention_fwd_kernel_tc(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int BH, int S,
                              int D, int n_groups, float scale, int causal,
                              int window) {
  using C = TcCfg<NG>;
  constexpr int ST = C::kStages;
  constexpr int WG = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle acts on address bits 4-9: align the tiles to 1024 bytes.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  // Q (one tile per consumer) | K stages | V stages | barriers (Q full,
  // stage full, stage empty).
  const uint32_t q_s = sbase;
  const uint32_t k_s = sbase + WG * C::kTileBytes;
  const uint32_t v_s = k_s + ST * C::kTileBytes;
  const uint32_t bar_q = v_s + ST * C::kTileBytes;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * ST;

  // A block owns WG neighbouring 64-row query tiles of one head, one per
  // consumer warpgroup; all heads' heaviest groups are issued first (under
  // the causal mask the last tiles of a row read the most key tiles).
  const int group = n_groups - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int qt0 = group * WG;
  // Key tiles [first, end) that can hold a valid key for a real row of
  // query tile qt; an empty range for a tile wholly past S.
  const auto key_tiles = [&](int qt, int& first, int& end) {
    const int q0 = qt * kRows;
    if (q0 >= S) { first = end = 0; return; }
    const int last_row = min(q0 + kRows, S) - 1;
    const int k_end = causal ? last_row + 1 : S;
    first = window > 0 ? max(0, q0 - window + 1) / kRows : 0;
    end = (k_end + kRows - 1) / kRows;
  };
  // The block streams the union of its tiles' ranges: a later query
  // tile's range starts and ends no earlier than an earlier one's.
  int u_first, u_end, n_q = 1;
  key_tiles(qt0, u_first, u_end);
  for (int w = 1; w < WG; ++w) {
    int f, e;
    key_tiles(qt0 + w, f, e);
    if (e > f) { u_end = max(u_end, e); n_q = w + 1; }
  }
  const int n_tiles = u_end - u_first;

  if (threadIdx.x == 0) {
    const uint32_t fills = TMA ? 1 : 128;    // expect_tx, or 128 producers
    mbar_init(bar_q, fills);
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar_full + 8 * st, fills);
      mbar_init(bar_empty + 8 * st, 128 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WG) {
    // ---- producer warpgroup ------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    const int q0 = qt0 * kRows;
    if constexpr (TMA) {
      if (threadIdx.x == 128 * WG) {
        mbar_expect_tx(bar_q, n_q * C::kTileBytes);
        for (int w = 0; w < n_q; ++w)
          for (int a = 0; a < NG; ++a)
            tma_load_3d(q_s + w * C::kTileBytes + a * kAtomBytes, &qmap,
                        bar_q, a * kAtom, q0 + w * kRows, bh);
        for (int t = 0; t < n_tiles; ++t) {
          const int st = t % ST;
          if (t >= ST) mbar_wait(bar_empty + 8 * st, ((t / ST) - 1) & 1);
          const int k0 = (u_first + t) * kRows;
          const uint32_t full = bar_full + 8 * st;
          mbar_expect_tx(full, 2 * C::kTileBytes);
          for (int a = 0; a < NG; ++a) {
            tma_load_3d(k_s + st * C::kTileBytes + a * kAtomBytes, &kmap,
                        full, a * kAtom, k0, bh);
            tma_load_3d(v_s + st * C::kTileBytes + a * kAtomBytes, &vmap,
                        full, a * kAtom, k0, bh);
          }
        }
      }
    } else {
      const int pt = threadIdx.x - 128 * WG;
      const long long off = (long long)bh * S * D;
      for (int w = 0; w < WG; ++w)
        stage_plain<NG>(q + off, base + w * C::kTileBytes, pt,
                        q0 + w * kRows, S, D);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % ST;
        if (t >= ST) mbar_wait(bar_empty + 8 * st, ((t / ST) - 1) & 1);
        const int k0 = (u_first + t) * kRows;
        stage_plain<NG>(k + off, base + (WG + st) * C::kTileBytes,
                        pt, k0, S, D);
        stage_plain<NG>(v + off,
                        base + (WG + ST + st) * C::kTileBytes, pt,
                        k0, S, D);
        // generic-proxy writes, read next by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(bar_full + 8 * st);
      }
    }
  } else {
    // ---- consumer warpgroups -----------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 :: "n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int q0 = (qt0 + wg) * kRows;
    int first, end;
    key_tiles(qt0 + wg, first, end);
    // This warpgroup's tiles in the block's stream; it passes over the
    // others (waits for them and releases them) so every stage is freed
    // by every consumer, in order.
    const int t_begin = end > first ? first - u_first : n_tiles;
    const int t_end = end > first ? end - u_first : n_tiles;
    const auto pass = [&](int t) {
      mbar_wait(bar_full + 8 * (t % ST), (t / ST) & 1);
      mbar_arrive(bar_empty + 8 * (t % ST));
    };
    for (int t = 0; t < t_begin; ++t) pass(t);

    if (t_begin < t_end) {
      // wgmma's accumulator fragment: register i of a 64 x 64 tile holds
      // row 16 warp + lane/4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
      // 2 (lane % 4) + (i & 1).  Each thread owns two rows; four lanes
      // share a row.
      const int qi0 = q0 + 16 * warp + (lane >> 2);
      const int qi1 = qi0 + 8;
      const int cq = 2 * (lane & 3);

      float acc[NG][32];
#pragma unroll
      for (int a = 0; a < NG; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

      const uint64_t dq = sw128_desc(q_s + wg * C::kTileBytes, 16, 1024);
      mbar_wait(bar_q, 0);

      for (int t = t_begin; t < t_end; ++t) {
        const int st = t % ST;
        const int k0 = (u_first + t) * kRows;

        // s = Q K^T over D / 16 steps (32 bytes along each swizzled row).
        mbar_wait(bar_full + 8 * st, (t / ST) & 1);
        const uint64_t dk = sw128_desc(k_s + st * C::kTileBytes, 16, 1024);
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NG; ++kk) {
          const uint32_t step =
              ((kk >> 2) * kAtomBytes + (kk & 3) * 32) >> 4;
          wgmma_ss(s, dq + step, dk + step, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // Scale after the dot, mask, then the online-softmax update.  A
        // tile whose every (query, key) pair is valid skips the mask.
        const bool inside = k0 + kRows <= S &&
                            (!causal || k0 + kRows - 1 <= q0) &&
                            (window == 0 || k0 > q0 + kRows - 1 - window);
        float mx0 = kNegInf, mx1 = kNegInf;
        if (inside) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            s[i] *= scale;
            if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int kj = k0 + 8 * (i >> 2) + cq + (i & 1);
            const int qi = (i & 2) ? qi1 : qi0;
            bool ok = kj < S;              // padded keys are never attended
            if (causal) ok = ok && kj <= qi;
            if (window > 0) ok = ok && kj > qi - window;
            s[i] = ok ? s[i] * scale : kNegInf;
            if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
          }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i & 2) { s[i] = expf(s[i] - mn1); rs1 += s[i]; }
          else       { s[i] = expf(s[i] - mn0); rs0 += s[i]; }
        }
        // l0, l1: this lane's share of the row sums, added up at the end
        l0 = l0 * c0 + rs0;
        l1 = l1 * c1 + rs1;
        m0 = mn0;
        m1 = mn1;

#pragma unroll
        for (int a = 0; a < NG; ++a)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[a][i] *= (i & 2) ? c1 : c0;

        // acc += P V with P = p_hi + p_lo.  The score fragment of keys
        // 16 ks .. 16 ks + 15 (registers 8 ks .. 8 ks + 7) is wgmma's A
        // fragment of that k-step.  All fragments are made before the
        // first wgmma reads any of them.
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1], hi[ks][j],
                       lo[ks][j]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int a = 0; a < NG; ++a) {
            const uint64_t dv = sw128_desc(
                v_s + st * C::kTileBytes + a * kAtomBytes + ks * 16 * 128,
                kAtomBytes, 1024);
            wgmma_rs(acc[a], hi[ks], dv);
            wgmma_rs(acc[a], lo[ks], dv);
          }
        }
        wgmma_commit();

        wgmma_wait_all();
#pragma unroll
        for (int a = 0; a < NG; ++a) pin(acc[a]);
        mbar_arrive(bar_empty + 8 * st);
      }

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = o + (long long)bh * S * D;
#pragma unroll
      for (int a = 0; a < NG; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i & 2) ? qi1 : qi0;
          const int col = a * kAtom + 8 * (i >> 2) + cq + (i & 1);
          if (row < S && col < D)
            out[(long long)row * D + col] =
                __float2bfloat16_rn(acc[a][i] / ((i & 2) ? den1 : den0));
        }
    }
    for (int t = t_end; t < n_tiles; ++t) pass(t);
  }
}

// cuTensorMapEncodeTiled is a driver-API function: reach it through the
// runtime's entry-point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over (D, S, BH) of a bf16 (BH, S, D) tensor, 64 x 64 boxes,
// 128-byte swizzle; what lies outside the tensor reads as zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int S, int D) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {kAtom, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NG, bool TMA>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int bh, int S, int D, float scale, int causal,
                      int window, cudaStream_t stream) {
  using C = TcCfg<NG>;
  auto kernel = flash_attention_fwd_kernel_tc<NG, TMA>;
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    // setmaxnreg.inc draws on the registers the block's own producer gave
    // back (a per-block pool): asking for more would wait forever.
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (kProducerRegs + C::kConsumers * kConsumerRegs >
        (C::kConsumers + 1) * attr.numRegs)
      return cudaErrorInvalidConfiguration;
    raised[dev] = true;
  }
  CUtensorMap maps[3] = {};
  if (TMA) {
    const void* ptrs[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      err = make_map(&maps[i], ptrs[i], bh, S, D);
      if (err != cudaSuccess) return err;
    }
  }
  const int n_groups = (S + C::kConsumers * kRows - 1) /
                       (C::kConsumers * kRows);
  kernel<<<(unsigned)((long long)bh * n_groups), C::kThreads, C::kSmem,
           stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      bh, S, D, n_groups, scale, causal, window);
  return cudaGetLastError();
}

template <int NG>
cudaError_t launch_tc_variant(bool tma, const void* q, const void* k,
                              const void* v, void* o, int bh, int S, int D,
                              float scale, int causal, int window,
                              cudaStream_t stream) {
  return tma ? launch_tc<NG, true>(q, k, v, o, bh, S, D, scale, causal,
                                   window, stream)
             : launch_tc<NG, false>(q, k, v, o, bh, S, D, scale, causal,
                                    window, stream);
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int bh, int S, int D, float scale, int causal,
                        int window, cudaStream_t stream) {
  // TMA takes 16-byte aligned addresses and global strides.
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool tma = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  switch ((D + 63) / 64) {
    case 1: return launch_tc_variant<1>(tma, q, k, v, o, bh, S, D, scale, causal, window, stream);
    case 2: return launch_tc_variant<2>(tma, q, k, v, o, bh, S, D, scale, causal, window, stream);
    case 3: return launch_tc_variant<3>(tma, q, k, v, o, bh, S, D, scale, causal, window, stream);
    case 4: return launch_tc_variant<4>(tma, q, k, v, o, bh, S, D, scale, causal, window, stream);
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
      : dtype == 1 ? dispatch_tc(q, k, v, o, bh, S, D, scale, causal, window,
                                 st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
