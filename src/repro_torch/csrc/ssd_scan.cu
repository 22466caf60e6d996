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
// What bounds it on this card: bytes.  At the main path's shape (b = 4,
// S = 2048, H = 32, P = 64, G = 1, N = 128, Q = 256) the call writes 101 MB
// of f32 y and states and reads 40 MB, 0.042 ms at 3.35 TB/s; its products,
// with C B^T computed once per slab of 4 heads, are 10.8 GFLOP, 0.011 ms at
// the bf16 tensor-core peak.  Two paths, chosen by type:
//
// bf16 -> tensor cores, mma.sync m16n8k16 (bf16 in, f32 out), two kernels
// launched one after the other:
//   `ssd_chunk_y_mma_kernel`: one block of 4 warps per (cell, 64-row query
//     tile, slab of HB heads of one group); each warp owns 16 query rows.
//     HB is the largest divisor of H / G with HB * P <= 256 (128 when
//     N > 128, where C's fragments take twice the registers): 4 heads at
//     P = 64, so C B^T is computed H / (G * HB) times per tile, not H / G.
//     * C's 64 rows are loaded once, straight from global memory, as the A
//       fragments of C B^T and held in registers for the whole walk;
//     * a loop walks the 64-key tiles on or below the diagonal; a 2-stage
//       cp.async ring holds B (keys x N, zero-padded to 128 or 256 columns,
//       so the k-steps of C B^T need no guard) and the slab's x (keys x
//       HB * P: the slab's heads are neighbours in memory, so a row is
//       HB * P contiguous elements), raw bf16, each row padded by 16 bytes
//       so ldmatrix has no bank conflicts and a lane's addresses move by
//       constants from one k-step to the next;
//     * per 16 keys, S = C B^T (16 x 16 a warp, f32 fragments), then for each
//       head of the slab P' = S * exp2(c2[i] - c2[j]) * dt[j] on j <= i
//       (c2 = cum * log2(e); ex2.approx; the mask is compiled only into the
//       diagonal tile's walk), packed to bf16 pairs: two neighbouring 8-key
//       f32 fragments are the A fragment of P' x, so P' never touches shared
//       memory; dt is folded into P', so x goes to the tensor cores as
//       stored (ldmatrix.trans);
//     * the slab's width is a template argument where HB is the widest the
//       slab may be (the main path), so the head loop carries no guard;
//     * every block scans dt itself (one warp per head: a segment a lane,
//       then shuffles); positions past Q get dt = 0 and the last cum, so
//       keys past Q add 0 and no exponent overflows off the diagonal;
//     * y is staged through the x ring as f32 and leaves in 16-byte rows.
//   `ssd_chunk_state_mma_kernel`: one block of 4 warps per (cell, head,
//     128-row slab of N), 32 rows a warp, walking the chunk's key tiles
//     through a 2-stage ring whose two stages are both in flight while the
//     decays are scanned: state = B^T (w o x), w[q] = dt[q] * exp(cum[Q-1] -
//     cum[q]); B^T's A fragments come from the staged B tile by
//     ldmatrix.trans, and w is applied in f32 to x's B fragments in
//     registers, then repacked to bf16.  The first slab's block also writes
//     decay and chunk_decay.
//   What is rounded: P' and w o x, to bf16 (x, B and C are bf16 already);
//   every sum is f32.  `ssd_chunk_tiled_ref` (kernels/ssd_scan/ref.py)
//   rounds the same values.  Registers (ptxas -v, sm_90a) at the main
//   path's P = 64, N = 128: `ssd_chunk_y_mma_kernel<64, 8, 4>` 252, no
//   spill (its accumulators alone are 128, C's fragments 32), so two
//   blocks an SM; `ssd_chunk_state_mma_kernel<64>` 128, no spill.
// f32 -> `ssd_chunk_kernel`, CUDA cores: tensor cores take f32 only as TF32
//   (about three decimal digits), which cannot hold the f32 path to 1e-4
//   of its plain version.  Its design:
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
// Both paths take any Q, N a multiple of 8 up to 256, P in {16, 32, 64,
// 128} and any H / G.  The bf16 kernels are bound by latency, not by bytes
// or tensor-core rate: 8 warps an SM, held there by the y kernel's
// registers.  wgmma (accumulators split across a warpgroup), TMA and warp
// specialisation are the way from here to the byte bound.
#include "common.cuh"
#include "warp_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: tensor cores.
namespace tensor_core {

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;     // query rows and keys per tile
constexpr int kSlabN = 128;   // state rows per state block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of 16-byte chunk c of row r in a tile of `ch` chunks a
// row (8 bf16 a chunk; ch is even).  Rows are padded by one chunk: a row
// then starts 4 banks after the one above, so the 8 rows an ldmatrix
// reads fall in 8 different bank groups, and a lane's addresses differ
// from one k-step to the next by constants.
__host__ __device__ constexpr int tile_off(int r, int c, int ch) {
  return (r * (ch + 1) + c) << 3;
}

// Elements of one ring stage: 64 rows of `ch` chunks and the padding.
__host__ __device__ constexpr int stage_elems(int ch) {
  return tile_off(kTile, 0, ch);
}

// Start the copy of rows [r0, r0 + 64) of a slice whose rows are
// `row_stride` elements apart into a padded tile of CH chunks a row (CH =
// 0: `ch` chunks, known only at run time); chunks of rows >= n_rows or of
// index >= valid_ch are zero-filled.
template <int CH>
__device__ __forceinline__ void stage(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                      size_t row_stride, int r0, int n_rows, int ch_rt,
                                      int valid_ch) {
  const int ch = CH ? CH : ch_rt;
  for (int idx = threadIdx.x; idx < kTile * ch; idx += kThreads) {
    const int r = idx / ch;
    const int c = idx % ch;
    const bool ok = r0 + r < n_rows && c < valid_ch;
    repro::cp_async_16(dst + tile_off(r, c, ch),
                       ok ? src + size_t(r0 + r) * row_stride + c * 8 : src, ok);
  }
}

// One warp: out[q] = scale * sum_{t <= q} negA * dts[t] for q < L.  Each
// lane sums a contiguous segment, the segment totals are scanned by
// shuffles, then each lane writes its segment's prefixes.  Returns the
// unscaled sum over all L (every lane).
__device__ __forceinline__ float warp_cumsum(float* __restrict__ out,
                                             const float* __restrict__ dts, int L, float negA,
                                             float scale) {
  const int lane = threadIdx.x & 31;
  const int seg = (L + 31) / 32;
  const int lo = min(L, lane * seg);
  const int hi = min(L, lo + seg);
  float tot = 0.f;
  for (int q = lo; q < hi; ++q) tot += negA * dts[q];
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
  for (int q = lo; q < hi; ++q) {
    run += negA * dts[q];
    out[q] = run * scale;
  }
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Widest slab of heads a y block takes: C's fragments take NK * 4
// registers, the slab's accumulators slab / 2.
template <int NK>
__host__ __device__ constexpr int max_slab() {
  return NK <= 8 ? 256 : 128;
}

// Heads of a y block: the largest divisor of H / G with at most
// `max_heads`.
inline int slab_heads(int heads_per_group, int max_heads) {
  int hb = 1;
  for (int d = 1; d <= heads_per_group && d <= max_heads; ++d)
    if (heads_per_group % d == 0) hb = d;
  return hb;
}

// The y block's ring of B (64 x 16 * NK) and x (64 x hb * P) padded tiles,
// then dt and the scaled cumulative decays of its hb heads.
size_t y_smem_bytes(int Q, int NK, int P, int hb) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  return sizeof(bf16) * 2 * size_t(stage_elems(2 * NK) + stage_elems(hb * P / 8)) +
         sizeof(float) * 2 * size_t(hb) * Qp;
}

// y_diag of 64 query rows for a slab of heads of one group.  N <= 16 * NK
// (B's tile is zero-padded to 16 * NK columns, so the k-steps of C B^T need
// no guard).  HB > 0: the slab has exactly HB heads; HB = 0: hb_rt heads, at
// most max_slab / P (a guard per head).
template <int P, int NK, int HB>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_y_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                           const bf16* __restrict__ Cm, float* __restrict__ y, int nc, int Q,
                           int H, int G, int N, int hb_rt) {
  constexpr int HBMAX = HB ? HB : max_slab<NK>() / P;
  constexpr int DT = P / 8;  // 8-wide column tiles of one head's output
  constexpr int NPAD = 16 * NK;
  constexpr int BCH = NPAD / 8;
  const int hb = HB ? HB : hb_rt;
  const int W = hb * P;
  const int xch = W / 8;
  const int Qp = (Q + kTile - 1) / kTile * kTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);                      // 2 stages of 64 x NPAD
  bf16* Xs = Bs + 2 * stage_elems(BCH);                              // 2 stages of 64 x W
  float* c2s = reinterpret_cast<float*>(Xs + 2 * stage_elems(xch));  // hb x Qp
  float* dts = c2s + hb * Qp;                                // hb x Qp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int cell = blockIdx.x;  // batch * nc + chunk
  const int h0 = blockIdx.y * hb;
  const int g = h0 / (H / G);
  const int q_tile = gridDim.z - 1 - blockIdx.z;  // heaviest (last) query tiles first
  const int q0 = q_tile * kTile;
  const int S = nc * Q;
  const size_t t0 = size_t(cell / nc) * S + size_t(cell % nc) * Q;
  const size_t x_row = size_t(H) * P;
  const size_t bc_row = size_t(G) * N;
  const bf16* xb = x + (t0 * H + h0) * P;
  const bf16* bb = Bm + (t0 * G + g) * N;
  const bf16* cb = Cm + (t0 * G + g) * N;
  const int n_kt = q_tile + 1;      // key tiles on or below the diagonal
  const int rows_end = q0 + kTile;  // decays are needed on [0, rows_end)
  const int L = min(rows_end, Q);
  const int r_lo = warp * 16 + grp;  // this lane's rows of the tile: r_lo, r_lo + 8

  // Tile 0 is in flight while C's fragments and dt load and the decays
  // are scanned.
  stage<BCH>(Bs, bb, bc_row, 0, Q, BCH, N / 8);
  stage<HB * P / 8>(Xs, xb, x_row, 0, Q, xch, xch);
  repro::cp_async_commit();

  // C's A fragments: rows r_lo and r_lo + 8, columns 2 * quad (+ 8) of every
  // 16-wide k-step; zero past Q and past N.
  uint32_t cf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + r_lo + (e & 1) * 8;
      const int col = kk * 16 + (e >> 1) * 8 + 2 * quad;
      cf[kk][e] = r < Q && col < N
                      ? *reinterpret_cast<const uint32_t*>(cb + size_t(r) * bc_row + col)
                      : 0u;
    }

  for (int idx = tid; idx < hb * rows_end; idx += kThreads) {
    const int q = idx / hb;
    const int hh = idx - q * hb;
    dts[hh * Qp + q] = q < Q ? dt[(t0 + q) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  for (int hh = warp; hh < hb; hh += kWarps) {
    float* c2 = c2s + hh * Qp;
    const float last = warp_cumsum(c2, dts + hh * Qp, L, -expf(A_log[h0 + hh]), kLog2e);
    for (int q = L + lane; q < rows_end; q += 32) c2[q] = last * kLog2e;
  }

  float acc[HBMAX][DT][4];
#pragma unroll
  for (int hh = 0; hh < HBMAX; ++hh)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][d][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kTile;
    const bf16* Bt = Bs + (it & 1) * stage_elems(BCH);
    const bf16* Xt = Xs + (it & 1) * stage_elems(xch);
    repro::cp_async_wait<0>();  // tile it has landed
    // One barrier a tile: past it every thread's copies of tile it (and, on
    // the first, the decays) are visible, and no warp reads tile it - 1,
    // whose stage the copy of tile it + 1 now fills.
    __syncthreads();
    if (it + 1 < n_kt) {
      const int nxt = (it + 1) & 1;
      stage<BCH>(Bs + nxt * stage_elems(BCH), bb, bc_row, k0 + kTile, Q, BCH, N / 8);
      stage<HB * P / 8>(Xs + nxt * stage_elems(xch), xb, x_row, k0 + kTile, Q, xch, xch);
      repro::cp_async_commit();
    }
    // The tile's products; the causal mask runs only on the diagonal tile.
    auto walk = [&](auto diag_tag) {
      constexpr bool kDiag = decltype(diag_tag)::value;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        // S = C B^T for 16 keys: key tiles of 8 in s[0], s[1].
        float s[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t bf[4];
          repro::ldmatrix_x4(bf, Bt + tile_off(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                               2 * kk + ((lane >> 3) & 1), BCH));
          repro::mma_bf16_16816(s[0], cf[kk], bf[0], bf[1]);
          repro::mma_bf16_16816(s[1], cf[kk], bf[2], bf[3]);
        }
        const int j0 = k0 + ks * 16 + 2 * quad;  // keys j0 + 8 t + {0, 1}
#pragma unroll
        for (int hh = 0; hh < HBMAX; ++hh) {
          if (HB || hh < hb) {
            const float* c2 = c2s + hh * Qp;
            const float* dh = dts + hh * Qp;
            const float ci[2] = {c2[q0 + r_lo], c2[q0 + r_lo + 8]};
            uint32_t pa[4];  // P' as the A fragment of P' x
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const float2 cj = *reinterpret_cast<const float2*>(c2 + j0 + 8 * t);
              const float2 dj = *reinterpret_cast<const float2*>(dh + j0 + 8 * t);
              float p[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const float cjv = (e & 1) ? cj.y : cj.x;
                const float djv = (e & 1) ? dj.y : dj.x;
                p[e] = s[t][e] * repro::ex2_approx(ci[r] - cjv) * djv;
                if (kDiag && j0 + 8 * t + (e & 1) > q0 + r_lo + 8 * r) p[e] = 0.f;
              }
              pa[2 * t] = repro::pack_bf16x2(p[0], p[1]);
              pa[2 * t + 1] = repro::pack_bf16x2(p[2], p[3]);
            }
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
              uint32_t vf[4];  // B fragments of column tiles 2 dp and 2 dp + 1
              repro::ldmatrix_x4_trans(
                  vf, Xt + tile_off(ks * 16 + (lane & 15), hh * (P / 8) + 2 * dp + (lane >> 4),
                                    xch));
              repro::mma_bf16_16816(acc[hh][2 * dp], pa, vf[0], vf[1]);
              repro::mma_bf16_16816(acc[hh][2 * dp + 1], pa, vf[2], vf[3]);
            }
          }
        }
      }
    };
    if (it == q_tile)
      walk(std::true_type{});
    else
      walk(std::false_type{});
  }

  // Epilogue: no warp reads the x ring any more, so it takes y as f32 (64
  // rows of W floats padded by 4, within the ring's size); each warp writes
  // and reads back only its own rows.
  repro::cp_async_wait<0>();
  __syncthreads();
  float* Ys = reinterpret_cast<float*>(Xs);
  const int ych = W / 4, ypitch = W + 4;
#pragma unroll
  for (int hh = 0; hh < HBMAX; ++hh) {
    if (HB || hh < hb) {
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r_lo + 8 * r;
          const int col = hh * P + 8 * d + 2 * quad;
          *reinterpret_cast<float2*>(Ys + row * ypitch + col) =
              make_float2(acc[hh][d][2 * r], acc[hh][d][2 * r + 1]);
        }
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * ych; idx += 32) {
    const int row = warp * 16 + idx / ych;
    const int c = idx % ych;
    const int q = q0 + row;
    if (q < Q)
      *reinterpret_cast<float4*>(y + ((t0 + q) * H + h0) * P + c * 4) =
          *reinterpret_cast<const float4*>(Ys + row * ypitch + c * 4);
  }
}

// The state block's ring of B (64 keys x 128 rows of N) and x (64 x P)
// padded tiles, then w and cum over the chunk.
template <int P>
size_t state_smem_bytes(int Q) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  return sizeof(bf16) * 2 * size_t(stage_elems(kSlabN / 8) + stage_elems(P / 8)) +
         sizeof(float) * 2 * size_t(Qp);
}

// Rows [n0, n0 + 128) of one head's (N, P) chunk-end state, 32 a warp; the
// block of the first slab also writes the decays.
template <int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                               const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                               float* __restrict__ states, float* __restrict__ decay,
                               float* __restrict__ chunk_decay, int nc, int Q, int H, int G,
                               int N) {
  constexpr int DT = P / 8;
  constexpr int BCH = kSlabN / 8;
  constexpr int XCH = P / 8;
  const int Qp = (Q + kTile - 1) / kTile * kTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);             // 2 stages of 64 keys x 128
  bf16* Xs = Bs + 2 * stage_elems(BCH);                             // 2 stages of 64 keys x P
  float* ws = reinterpret_cast<float*>(Xs + 2 * stage_elems(XCH));  // dt, then w
  float* cum = ws + Qp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int cell = blockIdx.x;
  const int h = blockIdx.y;
  const int n0 = blockIdx.z * kSlabN;
  const int g = h / (H / G);
  const int S = nc * Q;
  const size_t t0 = size_t(cell / nc) * S + size_t(cell % nc) * Q;
  const size_t x_row = size_t(H) * P;
  const size_t bc_row = size_t(G) * N;
  const bf16* xb = x + (t0 * H + h) * P;
  const bf16* bb = Bm + (t0 * G + g) * N + n0;
  const int b_valid = min(BCH, (N - n0) / 8);
  const int n_kt = (Q + kTile - 1) / kTile;

  // Both stages of the ring are in flight while the decays are scanned.
  for (int t = 0; t < 2 && t < n_kt; ++t) {
    stage<BCH>(Bs + t * stage_elems(BCH), bb, bc_row, t * kTile, Q, BCH, b_valid);
    stage<XCH>(Xs + t * stage_elems(XCH), xb, x_row, t * kTile, Q, XCH, XCH);
    repro::cp_async_commit();
  }

  for (int q = tid; q < Q; q += kThreads) ws[q] = dt[(t0 + q) * H + h];
  __syncthreads();
  if (warp == 0) warp_cumsum(cum, ws, Q, -expf(A_log[h]), 1.f);
  __syncthreads();
  const float last = cum[Q - 1];
  for (int q = tid; q < Qp; q += kThreads) ws[q] = q < Q ? ws[q] * expf(last - cum[q]) : 0.f;
  if (blockIdx.z == 0) {
    for (int q = tid; q < Q; q += kThreads) decay[(t0 + q) * H + h] = expf(cum[q]);
    if (tid == 0) chunk_decay[size_t(cell) * H + h] = expf(last);
  }

  const int nb = warp * 32;  // this warp's state rows in the slab: two 16-row tiles
  const bool active = n0 + nb < N;
  float acc[2][DT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][d][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kTile;
    const bf16* Bt = Bs + (it & 1) * stage_elems(BCH);
    const bf16* Xt = Xs + (it & 1) * stage_elems(XCH);
    if (it + 1 < n_kt)
      repro::cp_async_wait<1>();  // tile it has landed, tile it + 1 may be in flight
    else
      repro::cp_async_wait<0>();
    __syncthreads();  // tile it visible to all; on the first, w too
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        uint32_t af[2][4];  // B^T: the warp's two 16-row tiles, 16 keys
#pragma unroll
        for (int m = 0; m < 2; ++m)
          repro::ldmatrix_x4_trans(af[m],
                                   Bt + tile_off(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                 (nb + 16 * m) / 8 + ((lane >> 3) & 1), BCH));
        const int j = k0 + ks * 16 + 2 * quad;  // keys j, j + 1 (b0) and j + 8, j + 9 (b1)
        const float2 w0 = *reinterpret_cast<const float2*>(ws + j);
        const float2 w1 = *reinterpret_cast<const float2*>(ws + j + 8);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vf[4];
          repro::ldmatrix_x4_trans(
              vf, Xt + tile_off(ks * 16 + (lane & 15), 2 * dp + (lane >> 4), XCH));
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // w o x, rounded once to bf16
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vf[e]));
            const float2 wv = (e & 1) ? w1 : w0;
            vf[e] = repro::pack_bf16x2(xv.x * wv.x, xv.y * wv.y);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            repro::mma_bf16_16816(acc[m][2 * dp], af[m], vf[0], vf[1]);
            repro::mma_bf16_16816(acc[m][2 * dp + 1], af[m], vf[2], vf[3]);
          }
        }
      }
    }
    if (it + 2 < n_kt) {
      __syncthreads();  // every warp is done with stage it & 1
      stage<BCH>(Bs + (it & 1) * stage_elems(BCH), bb, bc_row, k0 + 2 * kTile, Q, BCH,
                 b_valid);
      stage<XCH>(Xs + (it & 1) * stage_elems(XCH), xb, x_row, k0 + 2 * kTile, Q, XCH, XCH);
      repro::cp_async_commit();
    }
  }
  if (!active) return;
  float* st = states + (size_t(cell) * H + h) * N * P;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + nb + 16 * m + grp + 8 * r;
      if (n >= N) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(st + size_t(n) * P + 8 * d + 2 * quad) =
            make_float2(acc[m][d][2 * r], acc[m][d][2 * r + 1]);
    }
}

template <int P, int NK, int HB>
cudaError_t launch_y(const void* x, const void* dt, const void* A_log, const void* Bm,
                     const void* Cm, void* y, int b, int nc, int Q, int H, int G, int N, int hb,
                     cudaStream_t stream) {
  const size_t smem = y_smem_bytes(Q, NK, P, hb);
  auto kern = ssd_chunk_y_mma_kernel<P, NK, HB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(b * nc, H / hb, (Q + kTile - 1) / kTile), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<float*>(y), nc, Q, H, G, N, hb);
  return cudaGetLastError();
}

template <int P, int NK>
cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, void* y, void* states, void* decay, void* chunk_decay, int b,
                   int nc, int Q, int H, int G, int N, cudaStream_t stream) {
  constexpr int HBMAX = max_slab<NK>() / P;
  const int hb = slab_heads(H / G, HBMAX);
  cudaError_t err =
      hb == HBMAX
          ? launch_y<P, NK, HBMAX>(x, dt, A_log, Bm, Cm, y, b, nc, Q, H, G, N, hb, stream)
          : launch_y<P, NK, 0>(x, dt, A_log, Bm, Cm, y, b, nc, Q, H, G, N, hb, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = state_smem_bytes<P>(Q);
  auto kern = ssd_chunk_state_mma_kernel<P>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(b * nc, H, (N + kSlabN - 1) / kSlabN), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm), static_cast<float*>(states),
      static_cast<float*>(decay), static_cast<float*>(chunk_decay), nc, Q, H, G, N);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(const void* x, const void* dt, const void* A_log, const void* Bm,
                     const void* Cm, void* y, void* states, void* decay, void* chunk_decay,
                     int b, int nc, int Q, int H, int G, int N, cudaStream_t st) {
  if (N <= 128)
    return launch<P, 8>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G, N,
                        st);
  return launch<P, 16>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G, N,
                       st);
}

cudaError_t launch_p(int P, const void* x, const void* dt, const void* A_log, const void* Bm,
                     const void* Cm, void* y, void* states, void* decay, void* chunk_decay,
                     int b, int nc, int Q, int H, int G, int N, cudaStream_t st) {
  switch (P) {
    case 16:
      return launch_n<16>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                          N, st);
    case 32:
      return launch_n<32>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                          N, st);
    case 64:
      return launch_n<64>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                          N, st);
    case 128:
      return launch_n<128>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G,
                           N, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tensor_core
}  // namespace

REPRO_EXPORT_ERROR_STRING

// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                             const void* Cm, void* y, void* states, void* decay,
                             void* chunk_decay, int dtype, int b, int nc, int Q, int H, int G,
                             int P, int N, void* stream) {
  if (b == 0 || nc == 0 || Q == 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || N > 256 || N % 8 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return int(launch_p<float>(P, x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q,
                               H, G, N, st));
  if (dtype == repro::kBF16)
    return int(tensor_core::launch_p(P, x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b,
                                     nc, Q, H, G, N, st));
  return int(cudaErrorInvalidValue);
}
