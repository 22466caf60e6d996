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
// ~295 FLOP/byte ridge, so the floor is the KV bytes over 3.35 TB/s.  What
// the design does about it:
//   * one thread block per (sequence, KV head) serves all G = H / K query
//     heads of the group, so every page is read once (the TPU grid re-reads
//     it for each query head);
//   * the block reads its own block_table row and seq_len and stops at the
//     last token, so only the bytes the sequence holds are moved;
//   * each warp walks 4 tokens at a time and issues their K and V loads
//     together before using them, to keep several loads in flight;
//   * a token's dot products are reduced with warp shuffles; the four warps'
//     partial softmax states are merged once, through shared memory, at the
//     end.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTokensPerStep = 4;  // tokens one warp loads per step

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, const int* __restrict__ block_table,
                        const int* __restrict__ seq_lens, T* __restrict__ o, int H, int KH,
                        int page, int max_pages, float scale) {
  constexpr int DPL = HD / 32;  // dims per lane
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int seq_len = seq_lens[b];
  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * HD;
  const size_t page_stride = size_t(page) * tok_stride;
  const size_t lane_off = size_t(kh) * HD + lane * DPL;

  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    repro::load_f32<T, DPL>(q + (size_t(b) * H + kh * G + g) * HD + lane * DPL, qr[g]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) qr[g][i] *= scale;
  }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = w * kTokensPerStep; t0 < seq_len; t0 += kWarps * kTokensPerStep) {
    float kr[kTokensPerStep][DPL], vr[kTokensPerStep][DPL];
    bool ok[kTokensPerStep];
#pragma unroll
    for (int u = 0; u < kTokensPerStep; ++u) {
      const int t = t0 + u;
      ok[u] = t < seq_len;
      if (ok[u]) {
        const size_t off =
            size_t(table[t / page]) * page_stride + size_t(t % page) * tok_stride + lane_off;
        repro::load_f32<T, DPL>(kp + off, kr[u]);
        repro::load_f32<T, DPL>(vp + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }

    float s[kTokensPerStep][G];
#pragma unroll
    for (int u = 0; u < kTokensPerStep; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot = fmaf(qr[g][i], kr[u][i], dot);
        s[u][g] = dot;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kTokensPerStep; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kTokensPerStep; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);  // finite: token t0 is always valid
      const float corr = expf(m[g] - m_new);
      float p[kTokensPerStep];
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kTokensPerStep; ++u) {
        p[u] = ok[u] ? expf(s[u][g] - m_new) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float a = acc[g][i] * corr;
#pragma unroll
        for (int u = 0; u < kTokensPerStep; ++u) a = fmaf(p[u], vr[u][i], a);
        acc[g][i] = a;
      }
      m[g] = m_new;
    }
  }

  // Merge the warps' partial states.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[w][g][lane * DPL + i] = acc[g][i];
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
      const float wt = expf(sm_m[ww][g] - M);
      L = fmaf(sm_l[ww][g], wt, L);
      O = fmaf(sm_acc[ww][g][d], wt, O);
    }
    o[(size_t(b) * H + kh * G + g) * HD + d] = repro::from_f32<T>(L > 0.f ? O / L : 0.f);
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt, const void* sl,
                   void* o, int B, int H, int KH, int page, int max_pages, float scale,
                   cudaStream_t stream) {
  const dim3 grid(KH, B);
  paged_decode_kernel<T, HD, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(o), H, KH, page,
      max_pages, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_group(int G, const void* q, const void* kp, const void* vp, const void* bt,
                         const void* sl, void* o, int B, int H, int KH, int page, int max_pages,
                         float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, kp, vp, bt, sl, o, B, H, KH, page, max_pages, scale, st);
    case 2: return launch<T, HD, 2>(q, kp, vp, bt, sl, o, B, H, KH, page, max_pages, scale, st);
    case 4: return launch<T, HD, 4>(q, kp, vp, bt, sl, o, B, H, KH, page, max_pages, scale, st);
    case 8: return launch<T, HD, 8>(q, kp, vp, bt, sl, o, B, H, KH, page, max_pages, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// Returns the CUDA error code of the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_table, const void* seq_lens, void* o,
                                   int dtype, int B, int H, int KH, int hd, int page,
                                   int max_pages, float scale, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0) return int(cudaErrorInvalidValue);
  const int G = H / KH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32 && hd == 128)
    return int(launch_group<float, 128>(G, q, k_pages, v_pages, block_table, seq_lens, o, B, H,
                                        KH, page, max_pages, scale, st));
  if (dtype == repro::kF32 && hd == 64)
    return int(launch_group<float, 64>(G, q, k_pages, v_pages, block_table, seq_lens, o, B, H,
                                       KH, page, max_pages, scale, st));
  if (dtype == repro::kBF16 && hd == 128)
    return int(launch_group<__nv_bfloat16, 128>(G, q, k_pages, v_pages, block_table, seq_lens,
                                                o, B, H, KH, page, max_pages, scale, st));
  if (dtype == repro::kBF16 && hd == 64)
    return int(launch_group<__nv_bfloat16, 64>(G, q, k_pages, v_pages, block_table, seq_lens,
                                                o, B, H, KH, page, max_pages, scale, st));
  return int(cudaErrorInvalidValue);
}
