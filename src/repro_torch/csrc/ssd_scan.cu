// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunk_call` / `_ssd_chunk_kernel` in
// src/repro/kernels/ssd_scan/kernel.py.  Per (batch, chunk, head) cell of Q
// positions it computes what the Pallas body computes, in f32:
//
//   a        = -exp(A_log[h]) * dt                 (Q,)
//   cum      = cumsum(a)                           (Q,)
//   L[i, j]  = exp(cum[i] - cum[j]) for j <= i, else 0
//   y_diag   = ((C B^T) o L) (x * dt)              (Q, P)
//   state    = (B * exp(cum[Q-1] - cum))^T (x * dt)   (N, P)
//   decay    = exp(cum),  chunk_decay = exp(cum[Q-1])
//
// Layout (all contiguous): x (b, S, H, P) and B, C (b, S, G, N) in f32 or
// bf16; dt (b, S, H) and A_log (H,) f32; S = nc * Q.  Outputs are f32:
// y (b, S, H, P), states (b, nc, H, N, P) (the Pallas kernel's (N, P)
// order), decay (b, S, H), chunk_decay (b, nc, H).  B and C are read by
// group (head h reads group h / (H / G)); the JAX wrapper repeats them to
// every head first, which is H / G times the bytes.
//
// What bounds it on this card: bytes.  At the main path's shape (Q = 256,
// N = 128, P = 64, G = 1) a cell does ~2 * Q^2 / 2 * (N + P) + 2 * Q * N * P
// ~ 16.8 MFLOP against ~100 KB of f32 y and state written, so the ideal is
// below the ridge in bf16.  This first kernel does its FLOPs on the CUDA
// cores and recomputes C B^T for every head of a group, so its arithmetic is
// what limits it.  What the design does:
//   * a cell does not fit in one block's shared memory at Q = 256 (f32 B and
//     C are 128 KB each, L 256 KB), so one block takes 64 query rows of a
//     cell, keeps its C rows in shared memory and walks the 64-key tiles
//     below the diagonal (tiles above it are skipped).  The product is
//     linear, so the tiles just accumulate: no softmax state;
//   * blocks of a second kind each compute 64 rows of the (N, P) chunk-end
//     state, walking the chunk's key tiles with the decay to its end folded
//     into x * dt; the first of them also writes the decays;
//   * every block computes `cum` itself with a block-wide scan of the
//     chunk's dt (Q floats, negligible beside the tiles);
//   * every thread owns a 4 x 4 tile of scores and a 4 x (P / 16) tile of the
//     output, so each shared-memory read feeds 4 FMAs; rows are padded by
//     one float so column walks hit distinct banks;
//   * Q need not be a multiple of the tile: rows and keys past Q are masked.
// Tensor-core MMA (wgmma) on the C B^T and (.) (x * dt) products, TMA staging
// and sharing C B^T across the heads of a group are the next steps.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows (or state rows) per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty owns rows, tx owns columns
constexpr int kWarps = kThreads / 32;

size_t smem_floats(int Q, int N, int P) {
  // dt and cum over the chunk, C rows, B rows, x * dt rows, score tile.
  return 2 * size_t(Q) + size_t(kBQ) * (N + 1) + size_t(kBK) * (N + 1) +
         size_t(kBK) * (P + 1) + size_t(kBQ) * (kBK + 1);
}

// Stage rows [r0, r0 + ROWS) of a (rows, width) slice whose rows are
// `row_stride` elements apart into shared memory as f32 (leading dimension
// `ld`), row r multiplied by scale[r] (r counted from r0) when `scale` is
// given; rows >= n_rows are zero.  16-byte loads, neighbouring threads on
// neighbouring addresses; width is a multiple of 16 / sizeof(T).
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src, size_t row_stride, int r0,
                                          int n_rows, int width, const float* scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = width / kVec;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * kVec;
    float v[kVec];
    if (r0 + r < n_rows) {
      repro::load_f32<T, kVec>(src + size_t(r0 + r) * row_stride + c, v);
      const float s = scale ? scale[r] : 1.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] *= s;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * ld + c + i] = v[i];
  }
}

// cum[q] = sum_{t <= q} -exp(A_log) * dt[t] for q < Q: a block-wide scan,
// kThreads positions at a time (warp shuffles, then the warp totals).
__device__ __forceinline__ void chunk_cumsum(float* __restrict__ cum,
                                             const float* __restrict__ dts, int Q, float negA) {
  __shared__ float warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < Q; base += kThreads) {
    const int q = base + threadIdx.x;
    float v = q < Q ? negA * dts[q] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float before = 0.f, total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float t = warp_tot[w];
      if (w < warp) before += t;
      total += t;
    }
    if (q < Q) cum[q] = carry + before + v;
    carry += total;
    __syncthreads();  // warp_tot is rewritten by the next round
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A_log, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ states,
                     float* __restrict__ decay, float* __restrict__ chunk_decay, int nc, int Q,
                     int H, int G, int N) {
  constexpr int RQ = kBQ / 16;  // rows per thread
  constexpr int CK = kBK / 16;  // score columns per thread
  constexpr int CP = P / 16;    // output columns per thread
  const int LN = N + 1, LP = P + 1, LS = kBK + 1;

  extern __shared__ float smem[];
  float* dts = smem;
  float* cum = dts + Q;
  float* Cs = cum + Q;
  float* Bs = Cs + kBQ * LN;
  float* Xs = Bs + kBK * LN;
  float* Ps = Xs + kBK * LP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int cell = blockIdx.x;  // batch * nc + chunk
  const int h = blockIdx.y;
  const int g = h / (H / G);
  const int n_state = (N + kBQ - 1) / kBQ;  // state blocks per cell
  const int S = nc * Q;
  const int bi = cell / nc;
  const int c = cell % nc;
  const size_t t0 = size_t(bi) * S + size_t(c) * Q;  // first position of the cell

  const T* xb = x + (t0 * H + h) * P;
  const T* bb = Bm + (t0 * G + g) * N;
  const T* cb = Cm + (t0 * G + g) * N;
  const size_t x_row = size_t(H) * P;
  const size_t bc_row = size_t(G) * N;

  for (int q = tid; q < Q; q += kThreads) dts[q] = dt[(t0 + q) * H + h];
  __syncthreads();
  chunk_cumsum(cum, dts, Q, -expf(A_log[h]));  // ends with a barrier

  float acc[RQ][CP];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;

  if (int(blockIdx.z) < n_state) {
    // ---- chunk-end state rows [n0, n0 + 64) of (N, P) ----
    const int n0 = blockIdx.z * kBQ;
    const float last = cum[Q - 1];
    // fold the decay to the chunk's end into dt: w[q] = dt[q] * exp(last - cum[q])
    float* w = Ps;
    for (int q0 = 0; q0 < Q; q0 += kBK) {
      __syncthreads();  // the previous tile is no longer read
      for (int r = tid; r < kBK; r += kThreads)
        w[r] = q0 + r < Q ? dts[q0 + r] * expf(last - cum[q0 + r]) : 0.f;
      __syncthreads();
      load_rows<T, kBK>(Bs, LN, bb, bc_row, q0, Q, N, nullptr);
      load_rows<T, kBK>(Xs, LP, xb, x_row, q0, Q, P, w);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float bv[RQ], xv[CP];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int n = n0 + ty + 16 * i;
          bv[i] = n < N ? Bs[k * LN + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < CP; ++j) xv[j] = Xs[k * LP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
    }
    float* st = states + (size_t(cell) * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int n = n0 + ty + 16 * i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < CP; ++j) st[size_t(n) * P + tx + 16 * j] = acc[i][j];
    }
    if (blockIdx.z == 0) {
      for (int q = tid; q < Q; q += kThreads) decay[(t0 + q) * H + h] = expf(cum[q]);
      if (tid == 0) chunk_decay[size_t(cell) * H + h] = expf(last);
    }
    return;
  }

  // ---- y_diag rows [q0, q0 + 64): heaviest (last) query tiles first ----
  const int n_qt = (Q + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (blockIdx.z - n_state)) * kBQ;
  load_rows<T, kBQ>(Cs, LN, cb, bc_row, q0, Q, N, nullptr);

  for (int k0 = 0; k0 <= q0; k0 += kBK) {  // key tiles on or below the diagonal
    __syncthreads();  // the previous tile's B, x * dt and scores are no longer read
    load_rows<T, kBK>(Bs, LN, bb, bc_row, k0, Q, N, nullptr);
    load_rows<T, kBK>(Xs, LP, xb, x_row, k0, Q, P, dts + k0);
    __syncthreads();

    // scores (C B^T): rows ty + 16 i, keys tx + 16 j
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      float cv[RQ], bv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) cv[i] = Cs[(ty + 16 * i) * LN + n];
#pragma unroll
      for (int j = 0; j < CK; ++j) bv[j] = Bs[(tx + 16 * j) * LN + n];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
    // times the causal decay mask L
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj <= qi && qi < Q;
        Ps[(ty + 16 * i) * LS + tx + 16 * j] = ok ? s[i][j] * expf(cum[qi] - cum[kj]) : 0.f;
      }
    }
    __syncthreads();

    // acc += (scores o L) (x * dt): rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float pv[RQ], xv[CP];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * LS + k];
#pragma unroll
      for (int j = 0; j < CP; ++j) xv[j] = Xs[k * LP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
    float* yrow = y + ((t0 + q) * H + h) * P;
#pragma unroll
    for (int j = 0; j < CP; ++j) yrow[tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, void* y, void* states, void* decay, void* chunk_decay, int b,
                   int nc, int Q, int H, int G, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, N, P);
  auto kern = ssd_chunk_kernel<T, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_state = (N + kBQ - 1) / kBQ;
  const int n_qt = (Q + kBQ - 1) / kBQ;
  const dim3 grid(b * nc, H, n_state + n_qt);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A_log),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), static_cast<float*>(chunk_decay),
      nc, Q, H, G, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dt, const void* A_log, const void* Bm,
                     const void* Cm, void* y, void* states, void* decay, void* chunk_decay,
                     int b, int nc, int Q, int H, int G, int N, cudaStream_t st) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                           N, st);
    case 32:
      return launch<T, 32>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                           N, st);
    case 64:
      return launch<T, 64>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                           N, st);
    case 128:
      return launch<T, 128>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H,
                            G, N, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                             const void* Cm, void* y, void* states, void* decay,
                             void* chunk_decay, int dtype, int b, int nc, int Q, int H, int G,
                             int P, int N, void* stream) {
  if (b == 0 || nc == 0 || Q == 0) return 0;
  if (G <= 0 || H % G != 0 || N % 8 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return int(launch_p<float>(P, x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q,
                               H, G, N, st));
  if (dtype == repro::kBF16)
    return int(launch_p<__nv_bfloat16>(P, x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay,
                                       b, nc, Q, H, G, N, st));
  return int(cudaErrorInvalidValue);
}
