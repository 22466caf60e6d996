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
// What bounds it on this card: operations.  Causal prefill does about
// 2 * S * S * hd FLOPs per (batch, head) against 4 * S * hd elements of
// q, k, v and out: ~256 FLOP/byte in bf16 at S = 1024 and ~512 at S = 2048,
// around and above the H100's ~295 FLOP/byte ridge, and this kernel does
// its FLOPs on the CUDA cores (67 TFLOP/s f32), not the tensor cores, so
// its arithmetic is what limits it.  What the design does about it:
//   * one thread block per (query tile of 64 rows, query head, batch); a
//     loop inside the block walks the 64-key KV tiles (the TPU's sequential
//     `nkv` grid axis), so Q, the running max/sum and the 64 x hd output
//     accumulator never leave the SM;
//   * K/V tiles are staged in shared memory once per block and reused by
//     all 64 query rows; every thread owns a 4 x 4 tile of scores and a
//     4 x (hd / 16) tile of the output, so each shared-memory read feeds 4
//     FMAs;
//   * tiles above the causal diagonal or left of the window band are never
//     loaded; the grid starts with the heaviest (last) query tiles;
//   * ragged S and T are masked per element, so S need not be a multiple of
//     the tile (the TPU kernel requires it).
// The arithmetic is plain f32 FMA on the CUDA cores; tensor-core MMA
// (wgmma), TMA staging and warp specialisation are the next steps.
#include "common.cuh"

namespace {

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
    return int(launch<float, 128>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, st));
  if (dtype == repro::kF32 && hd == 64)
    return int(launch<float, 64>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, st));
  if (dtype == repro::kBF16 && hd == 128)
    return int(
        launch<__nv_bfloat16, 128>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, st));
  if (dtype == repro::kBF16 && hd == 64)
    return int(
        launch<__nv_bfloat16, 64>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, st));
  return int(cudaErrorInvalidValue);
}
