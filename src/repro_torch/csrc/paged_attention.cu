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

}  // namespace

REPRO_EXPORT_ERROR_STRING

// `partials` is f32 scratch of B * H * n_split * (hd + 2) elements (unused,
// may be null, when n_split == 1); n_split partitions of `partition` tokens
// must cover the table's max_pages * page.  Returns the CUDA error code of
// the first launch that failed (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_table, const void* seq_lens, void* o,
                                   void* partials, int dtype, int B, int H, int KH, int hd,
                                   int page, int max_pages, int partition, int n_split,
                                   float scale, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0) return int(cudaErrorInvalidValue);
  if (partition < 1 || n_split < 1 || (n_split > 1 && partials == nullptr) ||
      size_t(n_split) * partition < size_t(max_pages) * page)
    return int(cudaErrorInvalidValue);
  const int G = H / KH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
