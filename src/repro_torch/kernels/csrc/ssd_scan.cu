// Mamba2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.ssd_scan.ssd_scan_chunked
// (body _ssd_kernel).  Inputs, float32, row-major, flattened over
// (batch * head) = BH:  x (BH, L, P), dt (BH, L), a (BH,), b and c
// (BH, L, S), with L a multiple of the chunk length Q.  Outputs: y
// (BH, L, P) and the final state (BH, P, S), both float32.  Per chunk of
// Q steps, with cum = inclusive cumsum of dt * a over the chunk:
//
//   y[t]   = sum_{s <= t} (c_t . b_s) exp(cum_t - cum_s) dt_s x_s   (intra)
//          + exp(cum_t) (state c_t)                                 (inter)
//   state' = exp(cum_end) state
//          + sum_s exp(cum_end - cum_s) dt_s x_s (outer) b_s        (carry)
//
// with the state before a sequence's first chunk 0.
//
// Bound on this card: operations.  The function's float32 flops, with the
// scores and their product with x over the causal triangle only, are
// 2 Q(Q+1)/2 (S + P) + 4 Q P S a chunk: 5.66 GFLOP at mamba2-130m's
// served shape (BH 96, L 1024, P 64, S = Q = 128), 0.0844 ms at the 67
// TFLOP/s float32 rate, against 0.0461 ms for its bytes (chip_smoke.py
// ssd_bound).  All arithmetic stays float32 on the CUDA cores: the float32
// contract (rtol 1e-4 against the plain version) rules out TF32 tensor
// cores, and split-TF32 is later work.
//
// Design: three kernels, each with a grid over (sequence, chunk), so that
// every chunk of every sequence runs in parallel (a single kernel that
// walks a sequence's chunks in order fills at most BH blocks).  Only the
// carry is sequential, and it is an elementwise pass over P x S:
//
//   1. ssd_scan_chunk_state_kernel, grid (sequence, chunk, 64 columns of
//      P): the chunk's cumsum (a warp scan), w_s = exp(cum_end - cum_s)
//      dt_s, the chunk's own state Z = (w o x)^T b (P x S over Q) and its
//      decay exp(cum_end).  Writes Z, cum and the decay to the workspace.
//   2. ssd_scan_state_pass_kernel, grid (sequence, tiles of P x S): h = 0;
//      for each chunk in order, writes h over Z (the state *before* the
//      chunk), then h = decay h + Z; writes the final state.
//   3. ssd_scan_chunk_out_kernel<NPG>, grid (sequence, chunk): the causal
//      scores C B^T (scaled, masked, kept in shared memory), the inter term
//      C h^T times exp(cum_t) from the incoming state, then the intra term
//      scores x, in one register tile that is written to y once.
//
// Inside the blocks: every product is a register-tiled matrix product out
// of shared memory, 8 x 8 outputs a thread for the scores and the chunk
// state (16 floats read for 64 FMAs) and 8 x 4 NPG for y.  Operands are
// staged in k-slabs of 16, double-buffered: the next slab is loaded into
// registers with 16-byte loads that read whole sectors while the current
// one is multiplied, then stored, so a slab costs one barrier and its load
// latency hides behind the FMAs.  b, c and the state are stored
// transposed (k-major), so that a thread reads its rows and its columns
// as 16-byte vectors; the k-loops are unrolled over the slab.  Score tiles
// wholly past the diagonal are skipped a warp at a time, and so are the
// slabs of x past a warp's last row.  Shared memory: 26 KB a chunk-state
// block (128 threads, up to 167 registers: 3 an SM, measured faster than
// 4 with 128 registers and spills), 101 KB a chunk-out block (256
// threads, 128 registers: 2 an SM, 16 warps).
//
// Floors of the design at the served shape (each kernel's own bytes and
// flops): chunk state 1.61 GFLOP and ~101 MB, 0.030 ms; state pass ~53 MB,
// 0.016 ms; chunk out 4.05 GFLOP and ~176 MB, 0.060 ms; together ~0.11 ms.
// The design moves the chunk states through device memory (~25 MB each
// way, partly held in the 50 MB L2), which the function's bound does not
// count.
//
// Workspace (float32, allocated by the caller, nothing allocated here, so
// a call can be captured in a CUDA graph): Z and then the incoming states
// (BH, L/Q, P, S), cum (BH, L), the decays (BH, L/Q), in that order.
//
// Numerics: the masked triangle (s > t, where cum_t - cum_s > 0 and exp()
// may overflow) is never multiplied in: it is selected away, so an inf
// never meets a 0.  Every exp is expf.  Sums run in another order than
// the plain PyTorch version, so the two agree within a float32 tolerance,
// not bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 128;     // chunk length
constexpr int kMaxS = 128;     // state width (a multiple of 4)
constexpr int kMaxP = 128;     // head width (kernels/ssd_scan.py MAX_HEAD)
constexpr int kSlab = 16;      // depth of a staged k-slab
constexpr int kLd = 128 + 4;   // row stride of a staged tile of 128 columns
constexpr int kGridCap = 0x7fffffff;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void unpack(const float4 lo, const float4 hi,
                                       float (&v)[8]) {
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// -- 1. chunk state -----------------------------------------------------------

constexpr int kStateThreads = 128;
constexpr int kStateCols = 64;           // columns of P a block owns
constexpr int kLdx = kStateCols + 4;
// 16-byte pieces of a slab that one thread stages: x, then b.
constexpr int kStateX = kSlab * kStateCols / 4 / kStateThreads;
constexpr int kStateB = kSlab * kMaxS / 4 / kStateThreads;

// The next slab of x (the block's columns of P) and of b, held in
// registers while the current one is used.
struct StateSlab {
  float4 x[kStateX];
  float4 b[kStateB];
};

__device__ __forceinline__ void state_load(StateSlab& r,
                                           const float* __restrict__ xq,
                                           const float* __restrict__ bq,
                                           int s0, int np, int P, int S,
                                           int Q, bool xvec) {
#pragma unroll
  for (int n = 0; n < kStateX; ++n) {
    const int i = threadIdx.x + kStateThreads * n;
    const int s = i >> 4, p = 4 * (i & 15);
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s0 + s < Q) {
      const float* row = xq + (long long)(s0 + s) * P + p;
      if (xvec) {
        if (p < np) u = ld4(row);
      } else {
        if (p < np) u.x = row[0];
        if (p + 1 < np) u.y = row[1];
        if (p + 2 < np) u.z = row[2];
        if (p + 3 < np) u.w = row[3];
      }
    }
    r.x[n] = u;
  }
#pragma unroll
  for (int n = 0; n < kStateB; ++n) {
    const int i = threadIdx.x + kStateThreads * n;
    const int s = i >> 5, k = 4 * (i & 31);
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s0 + s < Q && k < S) u = ld4(bq + (long long)(s0 + s) * S + k);
    r.b[n] = u;
  }
}

// Stores a slab, x scaled by w_s (wend, zero past the chunk).
__device__ __forceinline__ void state_store(const StateSlab& r,
                                            float (*xs)[kLdx],
                                            float (*bs)[kLd],
                                            const float* wend, int s0) {
#pragma unroll
  for (int n = 0; n < kStateX; ++n) {
    const int i = threadIdx.x + kStateThreads * n;
    const int s = i >> 4, p = 4 * (i & 15);
    const float w = wend[s0 + s];
    st4(&xs[s][p], w * r.x[n].x, w * r.x[n].y, w * r.x[n].z, w * r.x[n].w);
  }
#pragma unroll
  for (int n = 0; n < kStateB; ++n) {
    const int i = threadIdx.x + kStateThreads * n;
    *reinterpret_cast<float4*>(&bs[i >> 5][4 * (i & 31)]) = r.b[n];
  }
}

// Z[p][k] = sum_s (w_s x[s][p]) b[s][k] for the block's 64 columns of P.
// Thread tile: p = 4 tp + {0..3} and 32 + 4 tp + {0..3}, k = 4 tk + {0..3}
// and 64 + 4 tk + {0..3}; neighbouring lanes read neighbouring 16 bytes.
// The slabs are double-buffered: the next one is loaded into registers
// while the current one is multiplied, so one barrier a slab remains.
__global__ void __launch_bounds__(kStateThreads, 3)
ssd_scan_chunk_state_kernel(const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ z, float* __restrict__ cum_out,
                            float* __restrict__ decay_out, long long n_blocks,
                            int L, int P, int S, int Q, bool xvec) {
  __shared__ __align__(16) float xs[2][kSlab][kLdx];   // w_s x[s][p]
  __shared__ __align__(16) float bs[2][kSlab][kLd];    // b[s][k]
  __shared__ float cum[kMaxQ];
  __shared__ float wend[kMaxQ];
  __shared__ float warp_total[kStateThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tp = tid >> 4, tk = tid & 15;
  const int nc = L / Q;
  const int slices = (P + kStateCols - 1) / kStateCols;

  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long pair = blk / slices;        // seq * nc + chunk
    const int pg0 = static_cast<int>(blk % slices) * kStateCols;
    const int np = P - pg0;                     // columns left from pg0
    const long long seq = pair / nc;
    const long long row0 = seq * L + (pair % nc) * Q;
    const float av = a[seq];
    const float* xq = x + row0 * P + pg0;
    const float* bq = b + row0 * S;

    StateSlab next;
    state_load(next, xq, bq, 0, np, P, S, Q, xvec);
    __syncthreads();   // the previous block is done with the buffers
    // cum: a scan in each warp, then the totals of the warps before.
    float d = 0.0f, v = 0.0f;
    if (tid < Q) {
      d = dt[row0 + tid];
      v = d * av;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_total[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_total[w];
    if (tid < Q) cum[tid] = v;
    __syncthreads();
    const float cend = cum[Q - 1];
    wend[tid] = tid < Q ? expf(cend - v) * d : 0.0f;
    if (tid < Q && pg0 == 0) cum_out[row0 + tid] = v;
    if (pg0 == 0 && tid == 0) decay_out[pair] = expf(cend);
    __syncthreads();
    state_store(next, xs[0], bs[0], wend, 0);
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    int buf = 0;
    for (int s0 = 0; s0 < Q; s0 += kSlab) {
      const bool more = s0 + kSlab < Q;
      if (more) state_load(next, xq, bq, s0 + kSlab, np, P, S, Q, xvec);
#pragma unroll
      for (int kk = 0; kk < kSlab; ++kk) {
        float xr[8], br[8];
        unpack(ld4(&xs[buf][kk][4 * tp]), ld4(&xs[buf][kk][32 + 4 * tp]), xr);
        unpack(ld4(&bs[buf][kk][4 * tk]), ld4(&bs[buf][kk][64 + 4 * tk]), br);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(xr[i], br[j], acc[i][j]);
      }
      if (more) state_store(next, xs[buf ^ 1], bs[buf ^ 1], wend, s0 + kSlab);
      __syncthreads();
      buf ^= 1;
    }

    float* zq = z + pair * P * S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = pg0 + 4 * tp + (i & 3) + 32 * (i >> 2);
      if (p >= P) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int k = 4 * tk + 64 * g;
        if (k < S)
          st4(zq + (long long)p * S + k, acc[i][4 * g], acc[i][4 * g + 1],
              acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
    }
  }
}

// -- 2. state pass ------------------------------------------------------------

constexpr int kPassThreads = 256;

// One thread carries four entries of one sequence's state across its
// chunks: z[c] becomes the state before chunk c.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_state_pass_kernel(float* __restrict__ z,
                           const float* __restrict__ decay,
                           float* __restrict__ state, long long n_blocks,
                           int nc, int ps4) {
  const int tiles = (ps4 + kPassThreads - 1) / kPassThreads;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long seq = blk / tiles;
    const int i = static_cast<int>(blk % tiles) * kPassThreads + threadIdx.x;
    if (i >= ps4) continue;
    float4* zq = reinterpret_cast<float4*>(z) + seq * nc * ps4 + i;
    const float* dq = decay + seq * nc;
    float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 next = zq[0];
    for (int k = 0; k < nc; ++k) {
      const float4 zc = next;
      if (k + 1 < nc) next = zq[(long long)(k + 1) * ps4];
      zq[(long long)k * ps4] = h;
      // The plain version's order: state * decay + chunk state.
      const float e = dq[k];
      h.x = __fadd_rn(__fmul_rn(h.x, e), zc.x);
      h.y = __fadd_rn(__fmul_rn(h.y, e), zc.y);
      h.z = __fadd_rn(__fmul_rn(h.z, e), zc.z);
      h.w = __fadd_rn(__fmul_rn(h.w, e), zc.w);
    }
    reinterpret_cast<float4*>(state)[seq * ps4 + i] = h;
  }
}

// -- 3. chunk out -------------------------------------------------------------

constexpr int kOutThreads = 256;
// 16-byte pieces of a transposed k-slab (128 rows) that one thread stages,
// and of one row of the slab.
constexpr int kOutPer = kMaxQ * kSlab / 4 / kOutThreads;
constexpr int kQuads = kSlab / 4;
static_assert(kSlab * 16 % kOutThreads == 0, "an x slab needs every thread");

struct OutSmem {
  float sc[kMaxQ][kLd];       // scores, transposed: sc[s][t]
  float ta[2][kSlab][kLd];    // c^T slabs (scores, inter)
  float tb[2][kSlab][kLd];    // b^T (scores), h^T (inter), x slabs (intra)
  float cum[kMaxQ];
  float dts[kMaxQ];
  float ecum[kMaxQ];
};

// The next slab of one operand, held in registers while the current one is
// used.
struct OutSlab {
  float4 v[kOutPer];
};

// r = src[row][k0 + k] for row < rows and k0 + k < S, else 0: a k-slab of a
// row-major (rows, S) operand, to be stored transposed.  Neighbouring
// lanes read a row's slab as neighbouring 16-byte pieces (whole sectors).
__device__ __forceinline__ void load_t(OutSlab& r,
                                       const float* __restrict__ src,
                                       int rows, int k0, int S) {
#pragma unroll
  for (int n = 0; n < kOutPer; ++n) {
    const int i = threadIdx.x + kOutThreads * n;
    const int row = i / kQuads, k = 4 * (i % kQuads);
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < rows && k0 + k < S) u = ld4(src + (long long)row * S + k0 + k);
    r.v[n] = u;
  }
}

// dst[k][row] = r (two lanes of a warp meet in a bank at most).
__device__ __forceinline__ void store_t(const OutSlab& r, float (*dst)[kLd]) {
#pragma unroll
  for (int n = 0; n < kOutPer; ++n) {
    const int i = threadIdx.x + kOutThreads * n;
    const int row = i / kQuads, k = 4 * (i % kQuads);
    dst[k][row] = r.v[n].x;
    dst[k + 1][row] = r.v[n].y;
    dst[k + 2][row] = r.v[n].z;
    dst[k + 3][row] = r.v[n].w;
  }
}

// r = x[s0 + s][p] for s0 + s < Q and p < P, else 0: a slab of x (rows s,
// 64 NPG columns), stored as it is.
template <int NPG>
__device__ __forceinline__ void load_x(OutSlab& r,
                                       const float* __restrict__ xq, int s0,
                                       int P, int Q, bool xvec) {
  constexpr int kVec = 16 * NPG;       // 16-byte pieces of a row
  static_assert(kSlab * kVec <= kOutPer * kOutThreads, "x slab too wide");
#pragma unroll
  for (int n = 0; n < kSlab * kVec / kOutThreads; ++n) {
    const int i = threadIdx.x + kOutThreads * n;
    const int s = i / kVec, p = 4 * (i % kVec);
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s0 + s < Q) {
      const float* row = xq + (long long)(s0 + s) * P + p;
      if (xvec) {
        if (p < P) u = ld4(row);
      } else {
        if (p < P) u.x = row[0];
        if (p + 1 < P) u.y = row[1];
        if (p + 2 < P) u.z = row[2];
        if (p + 3 < P) u.w = row[3];
      }
    }
    r.v[n] = u;
  }
}

template <int NPG>
__device__ __forceinline__ void store_x(const OutSlab& r, float (*dst)[kLd]) {
  constexpr int kVec = 16 * NPG;
#pragma unroll
  for (int n = 0; n < kSlab * kVec / kOutThreads; ++n) {
    const int i = threadIdx.x + kOutThreads * n;
    *reinterpret_cast<float4*>(&dst[i / kVec][4 * (i % kVec)]) = r.v[n];
  }
}

// NPG: 4-column groups of P that a thread holds in y (1 for P <= 64, 2 for
// P <= 128).  Three products in turn over one chain of double-buffered
// slabs (each phase's last step loads the next phase's first slab): the
// scores over S, the inter term over S, the intra term over the chunk.
template <int NPG>
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_scan_chunk_out_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ b,
                          const float* __restrict__ c,
                          const float* __restrict__ hin,
                          const float* __restrict__ cumg,
                          float* __restrict__ y, long long n_blocks, int L,
                          int P, int S, int Q, bool xvec) {
  extern __shared__ __align__(16) float smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nc = L / Q;
  // Scores: a warp owns rows w1r..w1r+63 and columns w1c..w1c+31; a
  // thread rows r1 + {0..3} and r1 + 32 + {0..3}, columns c1 + {0..3} and
  // c1 + 16 + {0..3}.
  const int w1r = 64 * (warp >> 2), w1c = 32 * (warp & 3);
  const int r1 = w1r + 4 * (lane >> 2), c1 = w1c + 4 * (lane & 3);
  // y: a warp owns rows 16 warp .. 16 warp + 15 and every column; a thread
  // rows r2 + {0..3} and r2 + 8 + {0..3}, columns c2 + {0..3} (+ 64).
  const int r2 = 16 * warp + 4 * (lane >> 4), c2 = 4 * (lane & 15);
  const int last2 = 16 * warp + 15;     // the warp's last row

  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long seq = blk / nc;
    const long long row0 = seq * L + (blk % nc) * Q;
    const float* cq = c + row0 * S;
    const float* bq = b + row0 * S;
    const float* xq = x + row0 * P;
    const float* hq = hin + blk * P * S;      // the state before the chunk
    float* yq = y + row0 * P;

    OutSlab na, nb;                           // the next slabs
    load_t(na, cq, Q, 0, S);
    load_t(nb, bq, Q, 0, S);
    __syncthreads();   // the previous block is done with the buffers
    if (tid < kMaxQ) {
      float cv = 0.0f, dv = 0.0f;
      if (tid < Q) {
        cv = cumg[row0 + tid];
        dv = dt[row0 + tid];
      }
      sm.cum[tid] = cv;
      sm.dts[tid] = dv;
      sm.ecum[tid] = expf(cv);
    }
    store_t(na, sm.ta[0]);
    store_t(nb, sm.tb[0]);
    __syncthreads();
    int buf = 0;

    // Scores: C B^T over S, skipping warp tiles wholly past the diagonal.
    const bool act1 = w1r < Q && w1c < Q && w1c <= w1r + 63;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < S; k0 += kSlab) {
      if (k0 + kSlab < S) {
        load_t(na, cq, Q, k0 + kSlab, S);
        load_t(nb, bq, Q, k0 + kSlab, S);
      } else {                                // the inter term's first slab
        load_t(na, cq, Q, 0, S);
        load_t(nb, hq, P, 0, S);
      }
      if (act1) {
#pragma unroll
        for (int kk = 0; kk < kSlab; ++kk) {
          float cr[8], br[8];
          unpack(ld4(&sm.ta[buf][kk][r1]), ld4(&sm.ta[buf][kk][r1 + 32]), cr);
          unpack(ld4(&sm.tb[buf][kk][c1]), ld4(&sm.tb[buf][kk][c1 + 16]), br);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
        }
      }
      store_t(na, sm.ta[buf ^ 1]);
      store_t(nb, sm.tb[buf ^ 1]);
      __syncthreads();
      buf ^= 1;
    }
    // score[t][s] = (c_t . b_s) exp(cum_t - cum_s) dt_s for s <= t < Q,
    // else 0 (a skipped tile stores zeros).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = c1 + (j & 3) + 16 * (j >> 2);
      const float cs = sm.cum[s], ds = sm.dts[s];
      float out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = r1 + (i & 3) + 32 * (i >> 2);
        out[i] = (act1 && s <= t && t < Q)
                     ? acc[i][j] * (expf(sm.cum[t] - cs) * ds)
                     : 0.0f;
      }
      st4(&sm.sc[s][r1], out[0], out[1], out[2], out[3]);
      st4(&sm.sc[s][r1 + 32], out[4], out[5], out[6], out[7]);
    }

    // y = exp(cum_t) (C h^T) + scores x, in one register tile.
    const bool act2 = 16 * warp < Q;
    float yacc[8][4 * NPG];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NPG; ++j) yacc[i][j] = 0.0f;
    for (int k0 = 0; k0 < S; k0 += kSlab) {
      const bool more = k0 + kSlab < S;
      if (more) {
        load_t(na, cq, Q, k0 + kSlab, S);
        load_t(nb, hq, P, k0 + kSlab, S);
      } else {                                // the intra term's first slab
        load_x<NPG>(na, xq, 0, P, Q, xvec);
      }
      if (act2) {
#pragma unroll
        for (int kk = 0; kk < kSlab; ++kk) {
          float cr[8], hr[4 * NPG];
          unpack(ld4(&sm.ta[buf][kk][r2]), ld4(&sm.ta[buf][kk][r2 + 8]), cr);
#pragma unroll
          for (int g = 0; g < NPG; ++g) {
            const float4 u = ld4(&sm.tb[buf][kk][c2 + 64 * g]);
            hr[4 * g] = u.x; hr[4 * g + 1] = u.y;
            hr[4 * g + 2] = u.z; hr[4 * g + 3] = u.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4 * NPG; ++j)
              yacc[i][j] = fmaf(cr[i], hr[j], yacc[i][j]);
        }
      }
      if (more) {
        store_t(na, sm.ta[buf ^ 1]);
        store_t(nb, sm.tb[buf ^ 1]);
      } else {
        store_x<NPG>(na, sm.tb[buf ^ 1]);
      }
      __syncthreads();
      buf ^= 1;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = sm.ecum[r2 + (i & 3) + 8 * (i >> 2)];
#pragma unroll
      for (int j = 0; j < 4 * NPG; ++j) yacc[i][j] *= e;
    }
    for (int s0 = 0; s0 < Q; s0 += kSlab) {
      const bool more = s0 + kSlab < Q;
      if (more) load_x<NPG>(na, xq, s0 + kSlab, P, Q, xvec);
      if (act2 && s0 <= last2) {
#pragma unroll
        for (int kk = 0; kk < kSlab; ++kk) {
          float sr[8], xr[4 * NPG];
          unpack(ld4(&sm.sc[s0 + kk][r2]), ld4(&sm.sc[s0 + kk][r2 + 8]), sr);
#pragma unroll
          for (int g = 0; g < NPG; ++g) {
            const float4 u = ld4(&sm.tb[buf][kk][c2 + 64 * g]);
            xr[4 * g] = u.x; xr[4 * g + 1] = u.y;
            xr[4 * g + 2] = u.z; xr[4 * g + 3] = u.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4 * NPG; ++j)
              yacc[i][j] = fmaf(sr[i], xr[j], yacc[i][j]);
        }
      }
      if (more) store_x<NPG>(na, sm.tb[buf ^ 1]);
      __syncthreads();
      buf ^= 1;
    }
    // One write of y: 16 lanes store a row's 64 columns as 16-byte pieces.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = r2 + (i & 3) + 8 * (i >> 2);
      if (t >= Q) continue;
      float* yr = yq + (long long)t * P;
#pragma unroll
      for (int g = 0; g < NPG; ++g) {
        const int p = c2 + 64 * g;
        const float* v = &yacc[i][4 * g];
        if (xvec) {
          if (p < P) st4(yr + p, v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p + e < P) yr[p + e] = v[e];
        }
      }
    }
  }
}

// The dynamic shared-memory limit is a property of a function on the
// current device: raise it once per device, on the first call, so that
// later calls (inside a CUDA graph capture, say) launch and nothing else.
cudaError_t prepare() {
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    const int bytes = static_cast<int>(sizeof(OutSmem));
    err = cudaFuncSetAttribute(ssd_scan_chunk_out_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_scan_chunk_out_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

int grid_of(long long n_blocks) {
  return static_cast<int>(n_blocks < kGridCap ? n_blocks : kGridCap);
}

}  // namespace

// Launches the scan's three kernels on `stream`.  `ws` is the workspace:
// bh * (L/Q) * P * S + bh * L + bh * (L/Q) floats, 16-byte aligned.
// Returns 0 or the first CUDA error: the caller (kernels/ssd_scan.py)
// checks shapes first and raises on an error.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* b, const float* c, float* y,
                            float* state, float* ws, int bh, int L, int P,
                            int S, int Q, void* stream) {
  if (bh < 1 || P < 1 || P > kMaxP || S < 4 || S > kMaxS || S % 4 != 0 ||
      Q < 1 || Q > kMaxQ || L < Q || L % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long nc = L / Q;
  float* z = ws;
  float* cum = z + bh * nc * P * S;
  float* decay = cum + static_cast<long long>(bh) * L;
  // Rows of x (and of y) are moved as float4 only when every row starts on
  // a 16-byte boundary: P a multiple of 4 and x itself aligned (a view of
  // x at an odd offset is read one float at a time).
  const bool xvec =
      (P & 3) == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(y) % 16 == 0;

  const long long n1 = bh * nc * ((P + kStateCols - 1) / kStateCols);
  ssd_scan_chunk_state_kernel<<<grid_of(n1), kStateThreads, 0, st>>>(
      x, dt, a, b, z, cum, decay, n1, L, P, S, Q, xvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ps4 = P * S / 4;
  const long long n2 =
      static_cast<long long>(bh) * ((ps4 + kPassThreads - 1) / kPassThreads);
  ssd_scan_state_pass_kernel<<<grid_of(n2), kPassThreads, 0, st>>>(
      z, decay, state, n2, static_cast<int>(nc), ps4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n3 = bh * nc;
  const size_t smem = sizeof(OutSmem);
  if (P <= 64)
    ssd_scan_chunk_out_kernel<1><<<grid_of(n3), kOutThreads, smem, st>>>(
        x, dt, b, c, z, cum, y, n3, L, P, S, Q, xvec);
  else
    ssd_scan_chunk_out_kernel<2><<<grid_of(n3), kOutThreads, smem, st>>>(
        x, dt, b, c, z, cum, y, n3, L, P, S, Q, xvec);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of each kernel, for head width P (the chunk-out
// instance follows P): out[0] chunk state, out[1] state pass, out[2] chunk
// out.  Also reports the chunk-out block's dynamic shared memory in
// out[3] (bytes).  Returns 0 or the first CUDA error.
extern "C" int ssd_scan_occupancy(int P, int* out) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], ssd_scan_chunk_state_kernel, kStateThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], ssd_scan_state_pass_kernel, kPassThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(OutSmem);
  err = P <= 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &out[2], ssd_scan_chunk_out_kernel<1>, kOutThreads,
                      smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &out[2], ssd_scan_chunk_out_kernel<2>, kOutThreads,
                      smem);
  out[3] = static_cast<int>(smem);
  return static_cast<int>(err);
}
