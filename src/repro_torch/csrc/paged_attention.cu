// Decode attention over a paged KV pool for Hopper (sm_90a): one query token
// per sequence, online softmax in f32 across the sequence's pages.
//
// Replaces the TPU kernel `paged_attention_kernel` / `_paged_kernel` in
// src/repro/kernels/paged_attention/kernel.py (oracle:
// src/repro/kernels/paged_attention/ref.py).  Positions >= seq_len are
// masked and pages past the sequence's end are never read.  seq_len must be
// >= 1 and every block_table entry a sequence reaches must name a page of
// the pool: the kernel reads them without checking.
//
// Layout: q (B, H, hd), k/v pages (P, page, K, hd), block_table
// (B, max_pages) int32, seq_lens (B,) int32, out (B, H, hd); f32 or bf16.
// One more shape, for absorbed MLA decode (deepseek-v2-lite), runs its own
// split kernel, `paged_mla_split_kernel` (see below): keys of 576 (latent
// 512 ‖ rope 64) and values that are the first 512 columns of the same rows,
// one KV head, groups of 16 (or 4) query heads.
//
// What bounds it on this card: bytes.  Each cached token's K and V row is
// used for 2 * G * hd FLOPs per 4 * hd bytes (bf16), far below the H100's
// ~295 FLOP/byte ridge, so the floor is the KV bytes over 3.35 TB/s.  To
// reach it the card needs thousands of loads in flight at once, whatever
// the batch's lengths.  What the design does about it:
//   * split the sequence: `paged_split_kernel` runs one block per (KV head,
//     sequence, partition of `partition` tokens; the wrapper passes 256), so
//     a long sequence is walked by many blocks at once and the call no
//     longer lasts as long as one block's walk of the longest sequence.  The
//     wrapper sets the partition size and the number of partitions from the
//     block table's width (no read of seq_lens, so no host sync); a block
//     whose partition starts at or past seq_len writes an empty partial and
//     exits;
//   * each block serves all G = H / K query heads of its KV head, so every
//     page is read once (the TPU grid re-reads it for each query head), and
//     reads its own block-table entries;
//   * every load is 16 bytes a lane: a token's K (or V) row is read by
//     hd * sizeof(T) / 16 neighbouring lanes, and each lane keeps 8 (f32 at
//     hd 128) or 4 loads of K and as many of V in flight before using them;
//   * each lane runs its own online softmax over the tokens it loaded; the
//     lanes' states merge by shuffles, the warps' through shared memory;
//   * the block writes (max, sum, unnormalised output) per (sequence, query
//     head, partition) to f32 scratch the wrapper allocated, and
//     `paged_merge_kernel` (one block per (sequence, query head)) rescales
//     and sums them.  With a single partition the split kernel normalises
//     and writes the output itself, and no merge is launched.
// Scores live in the log2 domain (q is pre-scaled by scale * log2(e)).
//
// MLA (`paged_mla_split_kernel`, dk 576, dv 512, G = H / K of 16 or 4).  A
// token's row is 576 values, so a lane-per-dims split like the one above
// would need 72 lanes a row; and each row is read by G = 16 heads, ~30 FLOPs
// a byte in bf16 — on the CUDA cores (about 20 FLOPs a byte at 67 TFLOP/s
// against 3.35 TB/s) the work, not the bytes, is the floor here.  So the
// block (256 threads, one (KV head, sequence, partition)) stages tiles of 32
// tokens' rows in shared memory as f32, once for all G heads and for both
// products: the values are the rows' first dv columns, never loaded again.
//   * scores: each thread owns 4 heads x 4 tokens over a slice of the 576
//     dims (q transposed in shared memory, one 16-byte load of 4 heads and
//     4 key loads per 16 FMAs); the slices' partial scores sum through
//     shared memory;
//   * online softmax: one warp per head, a lane per token;
//   * P V: each thread owns dv / 256 output dims for all G heads;
//   * partials and the merge as above (the merge runs dv threads).
// The wrapper passes 128-token partitions.  Tensor cores (G = 16 is one
// m16n8k16 row tile) are the way to the byte bound.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens, T* __restrict__ o,
                       float* __restrict__ part, int H, int KH, int page, int max_pages,
                       int partition, int n_split, float scale_log2) {
  constexpr int EPL = 16 / sizeof(T);   // elements a lane loads at once
  constexpr int LPT = HD / EPL;         // lanes that share one token's row
  constexpr int TPW = 32 / LPT;         // tokens one warp-wide load covers
  constexpr int NL = TPW >= 2 ? 4 : 8;  // loads of K (and of V) a lane keeps in flight
  constexpr int U = NL * TPW;           // tokens a warp takes per step
  static_assert(LPT >= 1 && LPT <= 32 && 32 % LPT == 0, "a token row spans whole lanes");

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int B = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int seq_len = seq_lens[b];
  const int t_begin = split * partition;
  const int t_end = min(seq_len, t_begin + partition);
  const size_t bh0 = size_t(b) * H + size_t(kh) * G;  // first query head of the group
  float* part_m = part;
  float* part_l = part + size_t(B) * H * n_split;
  float* part_o = part + 2 * size_t(B) * H * n_split;

  if (t_begin >= t_end) {  // nothing of this sequence in the partition
    if (n_split == 1) {
      for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32)
        o[bh0 * HD + idx] = repro::from_f32<T>(0.f);
    } else if (threadIdx.x < G) {
      part_m[(bh0 + threadIdx.x) * n_split + split] = -INFINITY;
      part_l[(bh0 + threadIdx.x) * n_split + split] = 0.f;
    }
    return;
  }

  const int sub = lane / LPT;          // token of a warp-wide load
  const int d0 = (lane % LPT) * EPL;   // this lane's first dim
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    repro::load_f32<T, EPL>(q + (bh0 + g) * HD + d0, qr[g]);
#pragma unroll
    for (int i = 0; i < EPL; ++i) qr[g][i] *= scale_log2;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * HD;
  const size_t page_stride = size_t(page) * tok_stride;
  const size_t lane_off = size_t(kh) * HD + d0;

  for (int t0 = t_begin + w * U; t0 < t_end; t0 += kWarps * U) {
    uint4 kr[NL], vr[NL];
    bool ok[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = t0 + i * TPW + sub;
      ok[i] = t < t_end;
      if (ok[i]) {
        const size_t off =
            size_t(__ldg(table + t / page)) * page_stride + size_t(t % page) * tok_stride + lane_off;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kp + off));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vp + off));
      } else {
        kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // Scores of this lane's NL tokens for each head: partial dots, then a
    // sum over the LPT lanes of the token.
    float s[NL][G];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const T* kv = reinterpret_cast<const T*>(&kr[i]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], repro::to_f32(kv[e]), dot);
        s[i][g] = dot;
      }
    }
#pragma unroll
    for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);

    float vf[NL][EPL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const T* vv = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[i][e] = repro::to_f32(vv[e]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (ok[i]) mx = fmaxf(mx, s[i][g]);
      const float m_new = fmaxf(m[g], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;  // this lane has no token yet
      const float corr = exp2f(m[g] - mu);
      float ps = 0.f;
      float p[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        p[i] = ok[i] ? exp2f(s[i][g] - mu) : 0.f;
        ps += p[i];
      }
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int i = 0; i < NL; ++i) a = fmaf(p[i], vf[i][e], a);
        acc[g][e] = a;
      }
      m[g] = m_new;
    }
  }

  // Merge the lanes that hold the same dims of different tokens.
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], m2);
      const float mu = M == -INFINITY ? 0.f : M;
      const float a = exp2f(m[g] - mu);
      const float c = exp2f(m2 - mu);
      l[g] = l[g] * a + l2 * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float o2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + o2 * c;
      }
      m[g] = M;
    }
  }

  // Merge the warps' states through shared memory.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
  if (lane < LPT) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[w][g] = m[g];
        sm_l[w][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[w][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32) {
    const int g = idx / HD;
    const int d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      if (sm_m[ww][g] == -INFINITY) continue;  // this warp saw no token
      const float wt = exp2f(sm_m[ww][g] - M);
      L = fmaf(sm_l[ww][g], wt, L);
      O = fmaf(sm_acc[ww][g][d], wt, O);
    }
    const size_t bh = bh0 + g;
    if (n_split == 1) {
      o[bh * HD + d] = repro::from_f32<T>(L > 0.f ? O / L : 0.f);
    } else {
      part_o[(bh * n_split + split) * HD + d] = O;
      if (d == 0) {
        part_m[bh * n_split + split] = M;
        part_l[bh * n_split + split] = L;
      }
    }
  }
}

// out[b, h] = sum_i 2^(m_i - M) o_i / sum_i 2^(m_i - M) l_i over the
// non-empty partials i of (b, h); one block per (b, h), one thread per dim.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    paged_merge_kernel(const float* __restrict__ part, T* __restrict__ o, int BH, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part + bh * n_split;
  const float* pl = part + size_t(BH) * n_split + bh * n_split;
  const float* po = part + 2 * size_t(BH) * n_split + bh * n_split * HD;
  float M = -INFINITY;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, pm[i]);
  float L = 0.f, O = 0.f;
  for (int i = 0; i < n_split; ++i) {
    if (pm[i] == -INFINITY) continue;  // empty partition
    const float wt = exp2f(pm[i] - M);
    L = fmaf(pl[i], wt, L);
    O = fmaf(po[size_t(i) * HD + d], wt, O);
  }
  o[bh * HD + d] = repro::from_f32<T>(L > 0.f ? O / L : 0.f);
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt, const void* sl,
                   void* o, void* part, int B, int H, int KH, int page, int max_pages,
                   int partition, int n_split, float scale, cudaStream_t stream) {
  const dim3 grid(KH, B, n_split);
  paged_split_kernel<T, HD, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(o),
      static_cast<float*>(part), H, KH, page, max_pages, partition, n_split,
      scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<T, HD><<<B * H, HD, 0, stream>>>(static_cast<const float*>(part),
                                                     static_cast<T*>(o), B * H, n_split);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_group(int G, const void* q, const void* kp, const void* vp, const void* bt,
                         const void* sl, void* o, void* part, int B, int H, int KH, int page,
                         int max_pages, int partition, int n_split, float scale,
                         cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, HD, 1>(q, kp, vp, bt, sl, o, part, B, H, KH, page, max_pages,
                              partition, n_split, scale, st);
    case 2:
      return launch<T, HD, 2>(q, kp, vp, bt, sl, o, part, B, H, KH, page, max_pages,
                              partition, n_split, scale, st);
    case 4:
      return launch<T, HD, 4>(q, kp, vp, bt, sl, o, part, B, H, KH, page, max_pages,
                              partition, n_split, scale, st);
    case 8:
      return launch<T, HD, 8>(q, kp, vp, bt, sl, o, part, B, H, KH, page, max_pages,
                              partition, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// MLA: keys of DK, values the first DV columns of the same rows, G heads.
namespace mla {

constexpr int kThreads = 256;
constexpr int kTK = 32;  // tokens per shared-memory tile

template <int DK, int G>
struct Shape {
  static constexpr int kCombos = (G / 4) * (kTK / 4);     // (4 heads, 4 tokens) tiles
  static constexpr int kSplits = kThreads / kCombos;       // slices of the DK dims
  static constexpr int LDK = DK + 1;                       // padded K row (floats)
  static constexpr size_t kFloats = size_t(DK) * G         // q, transposed
                                    + size_t(kTK) * LDK    // the tile's rows
                                    + size_t(kSplits) * G * kTK  // partial scores
                                    + size_t(kTK) * G            // P
                                    + G;                         // rescale factors
};

template <typename T, int DK, int DV, int G>
__global__ void __launch_bounds__(kThreads)
    paged_mla_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                           T* __restrict__ o, float* __restrict__ part, int H, int KH, int page,
                           int max_pages, int partition, int n_split, float scale_log2) {
  using Sh = Shape<DK, G>;
  constexpr int LDK = Sh::LDK;
  constexpr int EPL = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int kChunks = DK / EPL;
  constexpr int NHG = G / 4;
  constexpr int DPS = DK / Sh::kSplits;  // dims of one slice
  constexpr int DPT = DV / kThreads;     // output dims of one thread
  constexpr int GW = (G + 7) / 8;        // heads of one warp in the softmax
  static_assert(G % 4 == 0 && kThreads % Sh::kCombos == 0 && DK % Sh::kSplits == 0 &&
                    DV % kThreads == 0 && DK % EPL == 0 && DV <= DK,
                "shape the MLA kernel does not tile");

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                           // [DK][G], pre-scaled
  float* Ks = Qt + DK * G;                    // [kTK][LDK]
  float* Sp = Ks + kTK * LDK;                 // [kSplits][G][kTK]
  float* Ps = Sp + Sh::kSplits * G * kTK;     // [kTK][G]
  float* corr_s = Ps + kTK * G;               // [G]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int B = gridDim.y;
  const int seq_len = seq_lens[b];
  const int t_begin = split * partition;
  const int t_end = min(seq_len, t_begin + partition);
  const size_t bh0 = size_t(b) * H + size_t(kh) * G;
  float* part_m = part;
  float* part_l = part + size_t(B) * H * n_split;
  float* part_o = part + 2 * size_t(B) * H * n_split;

  if (t_begin >= t_end) {  // nothing of this sequence in the partition
    if (n_split == 1) {
      for (int idx = tid; idx < G * DV; idx += kThreads) o[bh0 * DV + idx] = repro::from_f32<T>(0.f);
    } else if (tid < G) {
      part_m[(bh0 + tid) * n_split + split] = -INFINITY;
      part_l[(bh0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < G * DK; idx += kThreads) {
    const int g = idx / DK;
    const int d = idx % DK;
    Qt[d * G + g] = repro::to_f32(q[(bh0 + g) * DK + d]) * scale_log2;
  }

  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * DK;
  const size_t page_stride = size_t(page) * tok_stride;
  const int combo = tid % Sh::kCombos;
  const int hg = combo % NHG;  // this thread's 4 heads in the score tile
  const int tg = combo / NHG;  // and its 4 tokens
  const int d_lo = (tid / Sh::kCombos) * DPS;

  float acc[G][DPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[g][j] = 0.f;
  float m_run[GW], l_run[GW];  // this warp's heads warp + 8 i
#pragma unroll
  for (int i = 0; i < GW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kTK) {
    __syncthreads();  // Q is staged; the previous tile's rows and P are no longer read
    for (int idx = tid; idx < kTK * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * EPL;
      const int t = t0 + r;
      float v[EPL];
      if (t < t_end) {
        const size_t off = size_t(__ldg(table + t / page)) * page_stride +
                           size_t(t % page) * tok_stride + size_t(kh) * DK + c;
        repro::load_f32<T, EPL>(kp + off, v);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) Ks[r * LDK + c + i] = v[i];
    }
    __syncthreads();

    // Partial scores of 4 heads x 4 tokens over this thread's dims.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = d_lo; d < d_lo + DPS; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * G + hg * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tg * 4 + j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }
    float* sp = Sp + size_t(tid / Sh::kCombos) * G * kTK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(hg * 4 + i) * kTK + tg * 4 + j] = s[i][j];
    __syncthreads();

    // Online softmax: warp w takes heads w, w + 8; lane = token of the tile.
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      const int g = warp + 8 * i;
      if (g >= G) break;
      float sc = 0.f;
#pragma unroll
      for (int k = 0; k < Sh::kSplits; ++k) sc += Sp[(k * G + g) * kTK + lane];
      const bool ok = t0 + lane < t_end;
      sc = ok ? sc : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);  // finite: the tile's first token is visible
      const float corr = exp2f(m_run[i] - m_new);
      const float p = ok ? exp2f(sc - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[i] = l_run[i] * corr + ps;
      m_run[i] = m_new;
      Ps[lane * G + g] = p;
      if (lane == 0) corr_s[g] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V, V the first DV columns of the tile's rows.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float c = corr_s[g];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[g][j] *= c;
    }
#pragma unroll 2
    for (int t = 0; t < kTK; ++t) {  // rows past t_end are zero and their p is 0
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Ks[t * LDK + tid + j * kThreads];
#pragma unroll
      for (int gq = 0; gq < NHG; ++gq) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + t * G + gq * 4);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[gq * 4 + i][j] = fmaf(pa[i], vv[j], acc[gq * 4 + i][j]);
      }
    }
  }

  __syncthreads();  // Sp is free: it takes each head's max and sum
  float* sm_m = Sp;
  float* sm_l = Sp + G;
#pragma unroll
  for (int i = 0; i < GW; ++i) {
    const int g = warp + 8 * i;
    if (g < G && lane == 0) {
      sm_m[g] = m_run[i];
      sm_l[g] = l_run[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t bh = bh0 + g;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tid + j * kThreads;
      if (n_split == 1) {
        o[bh * DV + d] = repro::from_f32<T>(sm_l[g] > 0.f ? acc[g][j] / sm_l[g] : 0.f);
      } else {
        part_o[(bh * n_split + split) * DV + d] = acc[g][j];
      }
    }
    if (n_split > 1 && tid == 0) {
      part_m[bh * n_split + split] = sm_m[g];
      part_l[bh * n_split + split] = sm_l[g];
    }
  }
}

template <typename T, int DK, int DV, int G>
cudaError_t launch(const void* q, const void* kp, const void* bt, const void* sl, void* o,
                   void* part, int B, int H, int KH, int page, int max_pages, int partition,
                   int n_split, float scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<DK, G>::kFloats * sizeof(float);
  auto kern = paged_mla_split_kernel<T, DK, DV, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(KH, B, n_split);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const int*>(bt),
      static_cast<const int*>(sl), static_cast<T*>(o), static_cast<float*>(part), H, KH, page,
      max_pages, partition, n_split, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<T, DV><<<B * H, DV, 0, stream>>>(static_cast<const float*>(part),
                                                     static_cast<T*>(o), B * H, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_group(int G, const void* q, const void* kp, const void* bt, const void* sl,
                         void* o, void* part, int B, int H, int KH, int page, int max_pages,
                         int partition, int n_split, float scale, cudaStream_t st) {
  switch (G) {
    case 4:
      return launch<T, 576, 512, 4>(q, kp, bt, sl, o, part, B, H, KH, page, max_pages, partition,
                                    n_split, scale, st);
    case 16:
      return launch<T, 576, 512, 16>(q, kp, bt, sl, o, part, B, H, KH, page, max_pages,
                                     partition, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mla
}  // namespace

REPRO_EXPORT_ERROR_STRING

// `partials` is f32 scratch of B * H * n_split * (hd_v + 2) elements (unused,
// may be null, when n_split == 1); n_split partitions of `partition` tokens
// must cover the table's max_pages * page.  v_pages' rows are v_tok_stride
// elements apart: KH * hd for pages of their own (hd_v == hd), or, for MLA
// (hd 576, hd_v 512), v_pages is k_pages itself (the values are the first
// hd_v columns of the key rows).  Returns the CUDA error code of the first
// launch that failed (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_table, const void* seq_lens, void* o,
                                   void* partials, int dtype, int B, int H, int KH, int hd,
                                   int hd_v, int v_tok_stride, int page, int max_pages,
                                   int partition, int n_split, float scale, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0) return int(cudaErrorInvalidValue);
  if (partition < 1 || n_split < 1 || (n_split > 1 && partials == nullptr) ||
      size_t(n_split) * partition < size_t(max_pages) * page)
    return int(cudaErrorInvalidValue);
  const int G = H / KH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 576 && hd_v == 512) {
    if (v_pages != k_pages || v_tok_stride != KH * hd) return int(cudaErrorInvalidValue);
    if (dtype == repro::kF32)
      return int(mla::launch_group<float>(G, q, k_pages, block_table, seq_lens, o, partials, B,
                                          H, KH, page, max_pages, partition, n_split, scale, st));
    if (dtype == repro::kBF16)
      return int(mla::launch_group<__nv_bfloat16>(G, q, k_pages, block_table, seq_lens, o,
                                                  partials, B, H, KH, page, max_pages, partition,
                                                  n_split, scale, st));
    return int(cudaErrorInvalidValue);
  }
  if (hd_v != hd || v_tok_stride != KH * hd) return int(cudaErrorInvalidValue);
  if (dtype == repro::kF32 && hd == 128)
    return int(launch_group<float, 128>(G, q, k_pages, v_pages, block_table, seq_lens, o,
                                        partials, B, H, KH, page, max_pages, partition, n_split,
                                        scale, st));
  if (dtype == repro::kF32 && hd == 64)
    return int(launch_group<float, 64>(G, q, k_pages, v_pages, block_table, seq_lens, o,
                                       partials, B, H, KH, page, max_pages, partition, n_split,
                                       scale, st));
  if (dtype == repro::kBF16 && hd == 128)
    return int(launch_group<__nv_bfloat16, 128>(G, q, k_pages, v_pages, block_table, seq_lens,
                                                o, partials, B, H, KH, page, max_pages, partition,
                                                n_split, scale, st));
  if (dtype == repro::kBF16 && hd == 64)
    return int(launch_group<__nv_bfloat16, 64>(G, q, k_pages, v_pages, block_table, seq_lens,
                                               o, partials, B, H, KH, page, max_pages, partition,
                                               n_split, scale, st));
  return int(cudaErrorInvalidValue);
}
