// Prefill attention for Hopper (sm_90a): GQA with an online softmax in f32,
// causal and sliding-window masks by absolute position.
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py, with the same semantics as its
// oracle (src/repro/kernels/flash_attention/ref.py): a query row whose keys
// are all masked gives 0, not NaN.
//
// Layout: q (B, S, H, hd), k/v (B, T, K, hd), out (B, S, H, hd), all
// contiguous, f32 or bf16; query head h reads KV head h / (H / K).
//
// What bounds it on this card.  Causal prefill does about 2 * S * S * hd
// FLOPs per (batch, head) against 4 * S * hd elements of q, k, v and out:
// ~256 FLOP/byte in bf16 at S = 1024 and ~512 at S = 2048, around the
// H100's ~295 FLOP/byte ridge, so at the serve's lengths the floor is about
// as much bytes as tensor-core operations.  Two kernels, chosen by type:
//
// bf16 -> `flash_fwd_mma_kernel`, tensor cores (FlashAttention-2's shape):
//   * one block of 4 warps per (64 query rows, query head, batch), each warp
//     owning 16 rows; a loop inside the block walks 64-key KV tiles (the
//     TPU's sequential `nkv` grid axis), so the softmax state and the
//     output accumulator stay in registers;
//   * S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in, f32 out).  Q's
//     A fragments are loaded once (ldmatrix); K fragments come from
//     ldmatrix, V fragments from ldmatrix.trans;
//   * K and V tiles stay bf16 in a 2-stage shared-memory ring filled by
//     16-byte cp.async, so tile n + 1 is in flight while tile n is
//     computed, behind one barrier a tile; rows are XOR-swizzled by 16-byte chunk, so ldmatrix has no
//     bank conflicts.  ~80 KB of shared memory at hd 128: two blocks an SM;
//   * the mask and the online softmax run on the accumulator fragments in
//     registers (exp2, with scale * log2(e) folded into its argument's
//     FMA; a row's max and sum reduce over the 4 lanes of a quad); the
//     per-element mask runs only on tiles that cross the diagonal, the
//     window edge or the end of the keys;
//   * P, rounded to bf16 pairs, is already the A fragment of the P V
//     product, so it never touches shared memory;
//   * the output is staged through the Q buffer and stored as 16-byte rows.
// f32 -> `flash_fwd_kernel`, CUDA cores: tensor cores take f32 only as TF32
//   (about three decimal digits), which cannot hold the f32 path to 1e-4 of
//   its plain version, so f32 keeps plain FMAs on 64 x 64 tiles staged in
//   shared memory, a 4 x 4 register tile of scores per thread.
// Both: tiles above the causal diagonal or left of the window band are never
// loaded, the grid starts with the heaviest (last) query tiles, and ragged S
// and T are masked per element, so S need not be a multiple of the tile (the
// TPU kernel requires it).  wgmma, TMA and warp specialisation are the way
// from here to the byte bound.
#include "common.cuh"
#include "warp_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores.
namespace cuda_core {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty owns rows, tx owns columns

template <int HD>
constexpr size_t smem_bytes() {
  // Q, K, V tiles with a padded row (HD + 1 floats) so that column walks hit
  // distinct banks, plus the probability tile P (kBKV + 1 floats a row).
  return sizeof(float) * (size_t(kBQ) * (HD + 1) + 2 * size_t(kBKV) * (HD + 1) +
                          size_t(kBQ) * (kBKV + 1));
}

// Stage rows [r0, r0 + ROWS) of a (rows, HD) slice whose rows are
// `row_stride` elements apart into shared memory as f32; rows >= n_rows are
// zero.  16-byte loads, neighbouring threads on neighbouring addresses.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          size_t row_stride, int r0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    float v[kVec];
    if (r0 + r < n_rows) {
      repro::load_f32<T, kVec>(src + size_t(r0 + r) * row_stride + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * LD + c + i] = v[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int S, int T_len, int H, int KH, float scale, int causal,
                     int window) {
  constexpr int LD = HD + 1;
  constexpr int LDP = kBKV + 1;
  constexpr int RQ = kBQ / 16;   // query rows per thread
  constexpr int CK = kBKV / 16;  // score columns per thread
  constexpr int CD = HD / 16;    // output dims per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBKV * LD;
  float* Ps = Vs + kBKV * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = q_tile * kBQ;

  const size_t q_row = size_t(H) * HD;    // elements between query positions
  const size_t kv_row = size_t(KH) * HD;  // elements between key positions
  const T* qb = q + (size_t(b) * S * H + h) * HD;
  const T* kb = k + (size_t(b) * T_len * KH + kh) * HD;
  const T* vb = v + (size_t(b) * T_len * KH + kh) * HD;

  load_tile<T, HD, kBQ>(Qs, qb, q_row, q0, S);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that hold at least one visible key for some row of this tile:
  // below the diagonal of the tile's last row, right of the window edge of
  // its first row.
  int kv_end = T_len;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = (max(0, q0 - window + 1) / kBKV) * kBKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, HD, kBKV>(Ks, kb, kv_row, k0, T_len);
    load_tile<T, HD, kBKV>(Vs, vb, kv_row, k0, T_len);
    __syncthreads();

    // Scores: rows ty + 16 i, columns tx + 16 j.
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, then the online-softmax update.  The 16 threads that share a row
    // are the 16 lanes of one half-warp, so xor shuffles of 8..1 reduce it.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < T_len && qpos < S && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, output dims tx + 16 c.
#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int jd = 0; jd < CD; ++jd) vv[jd] = Vs[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jd = 0; jd < CD; ++jd) acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // fully masked row -> 0
    T* orow = o + ((size_t(b) * S + qpos) * H + h) * HD;
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) orow[tx + 16 * jd] = repro::from_f32<T>(acc[i][jd] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), S, T_len,
                                         H, KH, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bf16: tensor cores.
namespace tensor_core {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per KV tile
constexpr int kWarps = 4;      // each owns 16 query rows
constexpr int kThreads = kWarps * 32;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * size_t(HD) * (kBQ + 4 * kBKV);  // Q, 2 stages of K and of V
}

// Element offset of 16-byte chunk c of row r in a (rows, HD) bf16 tile whose
// chunks are XOR-swizzled by row: the 8 rows an ldmatrix reads land in 8
// different bank groups.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & 7)) << 3);
}

// Start the copy of rows [r0, r0 + ROWS) of a (n_rows, HD) slice whose rows
// are `row_stride` elements apart into a swizzled tile; rows >= n_rows are
// zero-filled.  Neighbouring threads copy neighbouring 16-byte chunks.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                           size_t row_stride, int r0, int n_rows) {
  constexpr int kChunks = HD / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = r0 + r < n_rows;
    repro::cp_async_16(dst + swz<HD>(r, c), src + size_t(ok ? r0 + r : 0) * row_stride + c * 8,
                       ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T_len, int H,
                         int KH, float scale_log2, int causal, int window) {
  constexpr int KS = HD / 16;   // k-steps of Q K^T
  constexpr int NT = kBKV / 8;  // 8-key column tiles of S
  constexpr int DT = HD / 8;    // 8-dim column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * HD;
  bf16* Vs = Ks + 2 * kBKV * HD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;   // fragment row (and row + 8)
  const int quad = lane & 3;   // fragment column pair
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = q_tile * kBQ;
  const int row0 = q0 + warp * 16 + grp;  // this lane's rows: row0, row0 + 8

  const size_t q_row = size_t(H) * HD;
  const size_t kv_row = size_t(KH) * HD;
  const bf16* qb = q + (size_t(b) * S * H + h) * HD;
  const bf16* kb = k + (size_t(b) * T_len * KH + kh) * HD;
  const bf16* vb = v + (size_t(b) * T_len * KH + kh) * HD;

  // KV tiles with at least one visible key for some row of this tile.
  int kv_end = T_len;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = (max(0, q0 - window + 1) / kBKV) * kBKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBKV - 1) / kBKV : 0;

  stage_tile<HD, kBQ>(Qs, qb, q_row, q0, S);
  repro::cp_async_commit();
  if (n_tiles > 0) {
    stage_tile<HD, kBKV>(Ks, kb, kv_row, kv_begin, T_len);
    stage_tile<HD, kBKV>(Vs, vb, kv_row, kv_begin, T_len);
  }
  repro::cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max of the unscaled scores
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  repro::cp_async_wait<1>();  // Q has landed (tile 0 may still be in flight)
  __syncthreads();
  uint32_t qf[KS][4];  // Q's A fragments, held for the whole walk
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    repro::ldmatrix_x4(qf[kk], Qs + swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kBKV;
    const bf16* Kt = Ks + (it & 1) * kBKV * HD;
    const bf16* Vt = Vs + (it & 1) * kBKV * HD;
    repro::cp_async_wait<0>();  // tile it has landed
    // One barrier a tile: past it, every thread's copies of tile it are
    // visible, and every warp is done with tile it - 1, whose stage the
    // copy of tile it + 1 now fills while tile it is computed.
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      stage_tile<HD, kBKV>(Ks + nxt * kBKV * HD, kb, kv_row, k0 + kBKV, T_len);
      stage_tile<HD, kBKV>(Vs + nxt * kBKV * HD, vb, kv_row, k0 + kBKV, T_len);
      repro::cp_async_commit();
    }

    // S = Q K^T: 16 rows x 64 keys per warp.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];  // B fragments of key tiles 2 np and 2 np + 1
        repro::ldmatrix_x4(
            kf, Kt + swz<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
        repro::mma_bf16_16816(s[2 * np], qf[kk], kf[0], kf[1]);
        repro::mma_bf16_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Mask only tiles that cross an edge.  Scores stay unscaled: the max is
    // taken on them and scale * log2(e) is folded into the exponent's FMA.
    const bool edge = k0 + kBKV > T_len || (causal && k0 + kBKV - 1 > q0) ||
                      (window > 0 && k0 < q0 + kBQ - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * quad + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          const bool ok = kpos < T_len && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          s[j][e] = ok ? s[j][e] : -INFINITY;
        }
    }

    // Online softmax on the fragment: rows row0 (e = 0, 1) and row0 + 8.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float mu[2];  // the row max in the log2 domain
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no key seen yet: p = 0, not NaN
      mu[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float corr = exp2f(fmaf(m[r], scale_log2, -mu[r]));
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }
    uint32_t pf[NT / 2][4];  // P as the A fragments of P V, one per 16 keys
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], scale_log2, -mu[0]));
      const float p1 = exp2f(fmaf(s[j][1], scale_log2, -mu[0]));
      const float p2 = exp2f(fmaf(s[j][2], scale_log2, -mu[1]));
      const float p3 = exp2f(fmaf(s[j][3], scale_log2, -mu[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = repro::pack_bf16x2(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = repro::pack_bf16x2(p2, p3);
    }

    // O += P V.
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];  // B fragments of dim tiles 2 dp and 2 dp + 1
        repro::ldmatrix_x4_trans(vf, Vt + swz<HD>(kk * 16 + (lane & 15), 2 * dp + (lane >> 4)));
        repro::mma_bf16_16816(acc[2 * dp], pf[kk], vf[0], vf[1]);
        repro::mma_bf16_16816(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  // Epilogue: every copy has landed and no warp reads Q any more, so the Q
  // buffer takes the output; each warp writes and reads back only its rows.
  repro::cp_async_wait<0>();  // Q's copies, when no tile was walked
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // fully masked row -> 0
  }
  const int r_lo = warp * 16 + grp;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<uint32_t*>(Qs + swz<HD>(r_lo, d) + 2 * quad) =
        repro::pack_bf16x2(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Qs + swz<HD>(r_lo + 8, d) + 2 * quad) =
        repro::pack_bf16x2(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * DT / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = idx / DT;
    const int c = idx % DT;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(o + ((size_t(b) * S + qpos) * H + h) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<HD>(warp * 16 + r, c));
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                         static_cast<const bf16*>(v), static_cast<bf16*>(o), S,
                                         T_len, H, KH, scale * 1.4426950408889634f, causal,
                                         window);
  return cudaGetLastError();
}

}  // namespace tensor_core
}  // namespace

REPRO_EXPORT_ERROR_STRING

// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int T_len, int H, int KH, int hd,
                                   float scale, int causal, int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KH <= 0 || H % KH != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32 && hd == 128)
    return int(cuda_core::launch<float, 128>(q, k, v, o, B, S, T_len, H, KH, scale, causal,
                                             window, st));
  if (dtype == repro::kF32 && hd == 64)
    return int(cuda_core::launch<float, 64>(q, k, v, o, B, S, T_len, H, KH, scale, causal,
                                            window, st));
  if (dtype == repro::kBF16 && hd == 128)
    return int(
        tensor_core::launch<128>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, st));
  if (dtype == repro::kBF16 && hd == 64)
    return int(
        tensor_core::launch<64>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, st));
  return int(cudaErrorInvalidValue);
}
