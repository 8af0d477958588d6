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
// the chunks of one sequence in order (the TPU kernel's "arbitrary" chunk
// grid axis).
//
// Bound on this card: operations.  Per chunk the scores C B^T and their
// product with x take 2 Q^2 (S + P) flops and the inter term and the carry
// 4 Q P S, against 4 Q (2P + 1 + 2S) bytes read or written: ~130 flops a
// byte at P = 64, S = Q = 128, above the card's float32 balance (67 TFLOP/s
// over 3.35 TB/s = 20).  What the design does about it: the four products
// of a chunk (scores, intra, inter, carry) run as small matrix products
// out of shared memory, each thread holding a register tile of outputs and
// reading its operands as 16-byte vectors that a warp shares, so the FMA
// units and not the shared-memory port set the pace.  One block owns one
// sequence and up to 64 columns of P (grid BH x ceil(P / 64): one block
// per sequence at every config's head width), walks its chunks in order
// with the state in shared memory, and keeps the chunk's b and c
// transposed (k-major) beside x, so each input element is read from device
// memory once.  The scores are made 32 rows at a time, and only up to the
// diagonal, which keeps the block's shared memory (220 KB at S = Q = 128)
// under the 227 KB limit.  All arithmetic is float32 on the CUDA cores (no
// TF32); the work is not yet on the tensor cores.
//
// Numerics: the masked triangle (s > t, where cum_t - cum_s > 0 and exp()
// may overflow) is never multiplied in: it is selected away, so an inf
// never meets a 0.  Sums run in another order than the plain PyTorch
// version (and the cumsum is a warp scan), so the two agree within a
// float32 tolerance, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;     // chunk length
constexpr int kMaxS = 128;     // state width (a multiple of 4)
constexpr int kMaxP = 128;     // head width (kernels/ssd_scan.py MAX_HEAD)
constexpr int kSlice = 64;     // columns of P per block
constexpr int kRows = 32;      // score rows made at a time
constexpr int kLdp = kSlice + 4;   // row stride of x and of the state
constexpr int kLdr = kRows + 4;    // row stride of the scores

struct Layout {
  int q4, ldq;       // chunk length rounded up to 4; row stride of b^T, c^T
  int ct, bt, xs, st, sc, cum, dts, ecum, wend, total;   // offsets, floats
};

__host__ __device__ inline Layout layout(int S, int Q) {
  Layout m;
  m.q4 = (Q + 3) & ~3;
  m.ldq = m.q4 + 4;
  m.ct = 0;                          // c^T [S][ldq]: c^T[k][t]
  m.bt = m.ct + S * m.ldq;           // b^T [S][ldq]: b^T[k][s]
  m.xs = m.bt + S * m.ldq;           // x   [q4][kLdp]: x[s][p], the slice
  m.st = m.xs + m.q4 * kLdp;         // state^T [S][kLdp]: state[p][k]
  m.sc = m.st + S * kLdp;            // scores^T [q4][kLdr]: score[t][s]
  m.cum = m.sc + m.q4 * kLdr;        // [q4] cumsum of dt * a
  m.dts = m.cum + m.q4;              // [q4] dt
  m.ecum = m.dts + m.q4;             // [q4] exp(cum_t)
  m.wend = m.ecum + m.q4;            // [q4] exp(cum_end - cum_s) dt_s
  m.total = m.wend + m.q4;
  return m;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, float* __restrict__ y,
                float* __restrict__ state_out, int L, int P, int S, int Q) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_total[kWarps];
  const Layout m = layout(S, Q);
  float* ct = smem + m.ct;
  float* bt = smem + m.bt;
  float* xs = smem + m.xs;
  float* st = smem + m.st;
  float* sc = smem + m.sc;
  float* cum = smem + m.cum;
  float* dts = smem + m.dts;
  float* ecum = smem + m.ecum;
  float* wend = smem + m.wend;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long seq = blockIdx.x;
  const int pg0 = blockIdx.y * kSlice;         // first column of the slice
  const int np = min(kSlice, P - pg0);
  const int q4 = m.q4, ldq = m.ldq;
  const float av = a[seq];
  const float* xq = x + seq * L * P + pg0;
  const float* dq = dt + seq * L;
  const float* bq = b + seq * L * S;
  const float* cq = c + seq * L * S;
  float* yq = y + seq * L * P + pg0;

  for (int i = tid; i < S * kLdp; i += kThreads) st[i] = 0.0f;

  // Register-tile coordinates, fixed for the whole run.
  //  scores: rows t0 + 0..3 (4 row groups a warp, 2 warps a 32-row pass),
  //          columns s0 + 0..3 (8 column groups a warp, 4 warps across);
  const int sc_row = 4 * ((lane >> 3) + 4 * (warp & 1));
  const int sc_col = 4 * ((lane & 7) + 8 * (warp >> 1));
  //  y:      the scores' rows, columns y_col + 0..1 (8 pairs a warp, 4
  //          warps across the 64 columns);
  const int y_row = sc_row;
  const int y_col = 2 * ((lane & 7) + 8 * (warp >> 1));
  //  carry:  state rows k = ck0 + 8j (j < 4), columns cp0 + 0..7.
  const int ck0 = (lane & 7) + 32 * (warp & 3);
  const int cp0 = 8 * (lane >> 3) + 32 * (warp >> 2);

  for (int c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();   // the previous chunk is done with the buffers
    // b and c transposed (k-major), zero beyond Q; S % 4 == 0, so a row
    // of S floats splits into 16-byte pieces.
    for (int i = tid; i < (S >> 2) * q4; i += kThreads) {
      const int s = i % q4, k = 4 * (i / q4);
      float4 vb = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vc = vb;
      if (s < Q) {
        vb = ld4(bq + (long long)(c0 + s) * S + k);
        vc = ld4(cq + (long long)(c0 + s) * S + k);
      }
      bt[(k + 0) * ldq + s] = vb.x;
      bt[(k + 1) * ldq + s] = vb.y;
      bt[(k + 2) * ldq + s] = vb.z;
      bt[(k + 3) * ldq + s] = vb.w;
      ct[(k + 0) * ldq + s] = vc.x;
      ct[(k + 1) * ldq + s] = vc.y;
      ct[(k + 2) * ldq + s] = vc.z;
      ct[(k + 3) * ldq + s] = vc.w;
    }
    for (int i = tid; i < q4 * kSlice; i += kThreads) {
      const int s = i / kSlice, p = i % kSlice;
      xs[s * kLdp + p] =
          (s < Q && p < np) ? xq[(long long)(c0 + s) * P + p] : 0.0f;
    }
    // cum = inclusive cumsum of dt * a: a scan in each warp, then the
    // totals of the warps before.
    float v = 0.0f;
    if (tid < q4) {
      const float d = tid < Q ? dq[c0 + tid] : 0.0f;
      dts[tid] = d;
      v = d * av;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_total[warp] = v;
    __syncthreads();
    if (tid < q4) {
      for (int w = 0; w < warp; ++w) v += warp_total[w];
      cum[tid] = v;
    }
    __syncthreads();
    if (tid < q4) {
      ecum[tid] = expf(cum[tid]);
      wend[tid] = tid < Q ? expf(cum[Q - 1] - cum[tid]) * dts[tid] : 0.0f;
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += kRows) {
      const int tmax = min(r0 + kRows, Q) - 1;
      // Scores: score[t][s] = (c_t . b_s) exp(cum_t - cum_s) dt_s for
      // s <= t, else 0; stored transposed, sc[s][t - r0], for s <= tmax.
      {
        const int t0 = r0 + sc_row, s0 = sc_col;
        if (t0 <= tmax && s0 <= tmax) {
          float acc[4][4] = {};
          for (int k = 0; k < S; ++k) {
            const float4 cv = ld4(ct + k * ldq + t0);
            const float4 bv = ld4(bt + k * ldq + s0);
            const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
            const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(ca[i], ba[j], acc[i][j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + j;
            float out[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int t = t0 + i;
              out[i] = (s <= t && t < Q)
                           ? acc[i][j] * (expf(cum[t] - cum[s]) * dts[s])
                           : 0.0f;
            }
            *reinterpret_cast<float4*>(sc + s * kLdr + (t0 - r0)) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
      }
      __syncthreads();
      // y rows t0..t0+3, columns p0, p0+1 of the slice:
      //   intra = sum_{s <= tmax} score[t][s] x[s][p]
      //   inter = sum_k c[t][k] state[p][k]
      {
        const int t0 = r0 + y_row, p0 = y_col;
        if (t0 <= tmax) {
          float intra[4][2] = {}, inter[4][2] = {};
          for (int s = 0; s <= tmax; ++s) {
            const float4 sv = ld4(sc + s * kLdr + (t0 - r0));
            const float2 xv = ld2(xs + s * kLdp + p0);
            const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              intra[i][0] = fmaf(sa[i], xv.x, intra[i][0]);
              intra[i][1] = fmaf(sa[i], xv.y, intra[i][1]);
            }
          }
          for (int k = 0; k < S; ++k) {
            const float4 cv = ld4(ct + k * ldq + t0);
            const float2 hv = ld2(st + k * kLdp + p0);
            const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              inter[i][0] = fmaf(ca[i], hv.x, inter[i][0]);
              inter[i][1] = fmaf(ca[i], hv.y, inter[i][1]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0 + i;
            if (t >= Q) continue;
            const float e = ecum[t];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (p0 + j < np)
                yq[(long long)(c0 + t) * P + p0 + j] =
                    intra[i][j] + inter[i][j] * e;
          }
        }
      }
      __syncthreads();
    }

    // Carry: state[p][k] = exp(cum_end) state[p][k]
    //                      + sum_s (wend_s x[s][p]) b[s][k].
    if (ck0 < S) {
      const float decay = expf(cum[Q - 1]);
      float acc[4][8] = {};
      for (int s = 0; s < q4; ++s) {
        const float w = wend[s];
        const float4 xa = ld4(xs + s * kLdp + cp0);
        const float4 xb = ld4(xs + s * kLdp + cp0 + 4);
        const float xw[8] = {w * xa.x, w * xa.y, w * xa.z, w * xa.w,
                             w * xb.x, w * xb.y, w * xb.z, w * xb.w};
        float bk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = ck0 + 8 * j;
          bk[j] = k < S ? bt[k * ldq + s] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc[j][n] = fmaf(xw[n], bk[j], acc[j][n]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = ck0 + 8 * j;
        if (k >= S) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* e = st + k * kLdp + cp0 + n;
          *e = decay * *e + acc[j][n];
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + seq * P * S + (long long)pg0 * S;
  for (int i = tid; i < np * S; i += kThreads) {
    const int p = i / S, k = i % S;
    so[(long long)p * S + k] = st[k * kLdp + p];
  }
}

}  // namespace

// Launches the scan on `stream`.  Returns 0 or the CUDA error code: the
// caller (kernels/ssd_scan.py) checks shapes first and raises on an error.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* b, const float* c, float* y,
                            float* state, int bh, int L, int P, int S, int Q,
                            void* stream) {
  if (bh < 1 || P < 1 || P > kMaxP || S < 4 || S > kMaxS || S % 4 != 0 ||
      Q < 1 || Q > kMaxQ || L < Q || L % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * layout(S, Q).total;
  // The dynamic shared-memory limit is a property of the function on the
  // current device: raise it once per device, on the first call, so that
  // later calls (inside a CUDA graph capture, say) launch and nothing
  // else.
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * layout(kMaxS, kMaxQ).total));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  dim3 grid(bh, (P + kSlice - 1) / kSlice);
  ssd_scan_kernel<<<grid, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, b, c, y, state, L, P, S, Q);
  return static_cast<int>(cudaGetLastError());
}
