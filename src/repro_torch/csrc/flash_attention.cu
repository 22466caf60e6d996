// Prefill attention for Hopper (sm_90a): GQA with an online softmax in f32,
// causal and sliding-window masks by absolute position.
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py, with the same semantics as its
// oracle (src/repro/kernels/flash_attention/ref.py): a query row whose keys
// are all masked gives 0, not NaN.
//
// Layout: q (B, S, H, dk), k (B, T, K, dk), v (B, T, K, dv), out (B, S, H,
// dv), all contiguous, f32 or bf16; query head h reads KV head h / (H / K).
// (dk, dv) is (64, 64), (128, 128), (80, 80) (h2o-danube-1.8b), (256, 256)
// (gemma3-4b) or, for MLA prefill and chunks folded into MHA form, (192,
// 128) (deepseek-v2-lite: keys [nope 128 ‖ rope 64], values 128) and (96,
// 64) (minicpm3-4b: [nope 64 ‖ rope 32], values 64).  At dk 96 a bf16 row is
// 12 16-byte chunks, so rows alternate between the two halves of a 128-byte
// line, and at dk 80 it is 10, a quarter line apart; the swizzle's 4- and
// 2-chunk tails keep every ldmatrix conflict-free (common.cuh::
// swizzle_chunk).  At (256, 256) the output accumulator alone is 128 f32
// registers a thread, and the tiles take 98,304 B in bf16 (32-key tiles:
// two blocks an SM, no spill) and 133,120 B in f32 (16-key tiles: one).
// Query row i stands at absolute position q_offset + i, and only the first
// kv_len <= T keys are visible: chunked prefill passes a slot's whole (B,
// s_max, K, hd) cache with q_offset = pos0 and kv_len = pos0 + C, so the
// per-batch stride of K and V comes from T, the bounds and masks from
// kv_len.
//
// What bounds it on this card.  Causal prefill does about 2 * S * S * hd
// FLOPs per (batch, head) against 4 * S * hd elements of q, k, v and out:
// ~256 FLOP/byte in bf16 at S = 1024 and ~512 at S = 2048, around the
// H100's ~295 FLOP/byte ridge, so at the serve's lengths the floor is about
// as much bytes as tensor-core operations.  In f32 the bytes double and
// each multiply costs three TF32 products (below): 494.7 TF/s / 3 ≈ 165
// TF/s effective, against 67 TF/s for FMAs on the CUDA cores, so f32 is
// bound by operations (0.13 ms of them against 0.05 ms of bytes at B = 2,
// S = 1024, 40 heads of 128).  Two kernels, chosen by type, one design:
//   * one block of 4 warps per (64 query rows, query head, batch), each warp
//     owning 16 rows; a loop inside the block walks KV tiles (the TPU's
//     sequential `nkv` grid axis), so the softmax state and the output
//     accumulator stay in registers;
//   * K and V tiles in a 2-stage shared-memory ring filled by 16-byte
//     cp.async, so tile n + 1 is in flight while tile n is computed, behind
//     one barrier a tile;
//   * the mask and the online softmax run on the accumulator fragments in
//     registers (exp2, with scale * log2(e) folded into its argument's
//     FMA; a row's max and sum reduce over the 4 lanes of a quad); the
//     per-element mask runs only on tiles that cross the diagonal, the
//     window edge or the end of the keys;
//   * P is already the A fragment of the P V product, so it never touches
//     shared memory;
//   * the output is staged through the Q buffer and stored as 16-byte rows;
//   * tiles above the causal diagonal or left of the window band are never
//     loaded, the grid starts with the heaviest (last) query tiles, and
//     ragged S and T are masked per element, so S need not be a multiple of
//     the tile (the TPU kernel requires it).
//
// bf16 -> `flash_fwd_mma_kernel` (FlashAttention-2's shape): 64-key tiles
//   (32 at dk 256);
//   S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in, f32 out).  Q's A
//   fragments are loaded once (ldmatrix) up to dk 128, and read from the Q
//   tile at each k-step at dk 192 (held, they would spill); K fragments come
//   from ldmatrix, V fragments from ldmatrix.trans; tiles stay bf16, rows
//   XOR-swizzled by 16-byte chunk, so ldmatrix has no bank conflicts.  ~80
//   KB of shared memory at (128, 128), ~104 KB at (192, 128) and ~96 KB at
//   (256, 256): two blocks an SM; ~52 KB at (96, 64) and ~51 KB at (80,
//   80), room for four.  P is rounded to bf16 pairs.  Measured at gemma3's
//   prefill (B = 2, S = 2048, H = 8, K = 4; NVIDIA H100 80GB HBM3 at 700 W,
//   graph timer, chip_smoke.py; PERF.md section 6): 64-key tiles at dk
//   256 (163,840 B, one block an SM, 64 bytes of spill) took 0.194 ms
//   windowed and 0.259 ms causal, 32-key tiles 0.151 and 0.207.
//
// f32 -> `flash_fwd_tf32x3_kernel`: both products on the tensor cores as
//   mma.sync m16n8k8 with TF32 inputs, three products per multiply
//   (CUTLASS's "fast accurate f32"): each operand x is split into big =
//   tf32(x), rounded to nearest (ties away, as cvt.rna.tf32.f32), and small
//   = x - big truncated to TF32, and a b is taken as big_a big_b + big_a
//   small_b + small_a big_b with f32 accumulators.  One TF32 product keeps
//   about three decimal digits; the pair holds each operand to 2^-21 and the
//   dropped small_a small_b is below 2^-22 of |a b|, so the kernel holds f32
//   to its plain version's limit (1e-4), whatever
//   torch.backends.cuda.matmul.allow_tf32 says; nothing runs one product.
//   A NaN operand leaves small a NaN, so it propagates.  exp2 is
//   ex2.approx.ftz (about 2 ulp).  `flash_attention_tiled_ref` with
//   `tf32_products=3` rounds exactly what this kernel rounds.
//   * Fragments.  ldmatrix.x4 (b16) loads Q's A fragments and K's B
//     fragments from the row-major f32 tiles (an 8x8 b16 matrix is 8 rows of
//     4 words).  V's B fragments are scalar loads (ldmatrix.trans would cut
//     each word in two): b0 from key row 2 quad, b1 from 2 quad + 1, which
//     matches P, whose A columns quad and quad + 4 stand for keys 2 quad and
//     2 quad + 1 (the sum over keys takes any order), so P goes from the
//     accumulator to the A fragment with no shuffle.
//   * Instruction order.  Each of the three products runs over every key tile (Q
//     K^T, with big * big and the two cross terms in separate accumulators)
//     or over 4 output tiles (P V) before the next starts, so consecutive
//     mma are independent.
//   * What bounds it.  Not the tensor cores (a quarter of the 3xTF32
//     bound's rate at the main case) but the instructions around them:
//     every warp splits the Q, K, V and P it loads, ~4 operations an
//     element, which with the fragment loads is about 4 instructions for
//     each mma, and the time moves with that count (below).
//   * Split point and rounding.  Every operand is split in registers as
//     its fragment is loaded, big rounded by two integer operations
//     (warp_mma.cuh::tf32_rna).  Q split once into big and small tiles in
//     shared memory would take 2 x 33 KB at dk 128, K and V split once at
//     staging twice their ring: either leaves room for two blocks an SM
//     only at 16-key tiles.  Measured beside this kernel (f32, B = 2, S =
//     1024, 40 heads of 128, causal; NVIDIA H100 80GB HBM3 at 700 W, graph
//     timer; PERF.md section 6): this kernel 0.509-0.527 ms; K and V split
//     once at staging (16-key tiles, a second barrier a tile, twice the
//     fragment loads) 0.582-0.597 ms; big by cvt.rna.tf32.f32 0.590-0.599
//     ms; both parts by cvt.rna.tf32.f32 0.705-0.726 ms.
//   * Tiles and shared memory: rows padded by 4 words (16 bytes), which puts
//     the 8 rows of an ldmatrix and the 4 rows of a warp's V load in
//     different banks without a swizzle.  Q (64 rows), then 2 stages of K
//     and V:
//       (64, 64):   32-key tiles, 17,408 + 2 x 17,408 =  52,224 B: 4 blocks;
//       (128, 128): 32-key tiles, 33,792 + 2 x 33,792 = 101,376 B: 2 blocks,
//                   8 warps an SM;
//       (192, 128): 16-key tiles, 50,176 + 2 x 20,992 =  92,160 B: 2 blocks;
//       (96, 64):   32-key tiles, 25,600 + 2 x 21,504 =  68,608 B: 3 blocks;
//       (80, 80):   32-key tiles, 21,504 + 2 x 21,504 =  64,512 B: 3 blocks;
//       (256, 256): 16-key tiles, 66,560 + 2 x 33,280 = 133,120 B: 1 block.
//   * Why not wgmma yet.  TF32 wgmma takes its operands K-major from shared
//     memory only; V, the B operand of P V, is (keys, dv) with dv
//     contiguous, so it would need a transposing stage, and the split
//     operands would need shared memory of their own.  A later change.
// wgmma, TMA and warp specialisation are the way from here to the bound.
#include "common.cuh"
#include "warp_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: three TF32 products on the tensor cores.
namespace tf32x3 {

constexpr int kBQ = 64;    // query rows per block
constexpr int kWarps = 4;  // each owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 4;    // f32 words of padding after every staged row

// Keys per KV tile: 32, and 16 at dk 192, so that two blocks fit an SM.
template <int DK>
constexpr int kKvTile = DK > 128 ? 16 : 32;

template <int DK, int DV>
constexpr size_t smem_bytes() {  // Q, 2 stages of K and V, padded rows
  return sizeof(float) *
         (size_t(kBQ) * (DK + kPad) + 2 * size_t(kKvTile<DK>) * (DK + kPad + DV + kPad));
}

// Start the copy of rows [r0, r0 + ROWS) of a (n_rows, HD) f32 slice whose
// rows are `row_stride` elements apart into a tile whose rows are HD + kPad
// words apart; rows >= n_rows are zero-filled.  The padding moves each row
// by 4 banks, so the 8 rows an ldmatrix reads, and the rows 2 * quad a
// warp's V loads read, fall in different banks.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_tile(float* __restrict__ dst, const float* __restrict__ src,
                                           size_t row_stride, int r0, int n_rows) {
  constexpr int kChunks = HD / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = r0 + r < n_rows;
    repro::cp_async_16(dst + r * (HD + kPad) + c * 4,
                       src + size_t(ok ? r0 + r : 0) * row_stride + c * 4, ok);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int S, int T_len,
                            int kv_len, int q_offset, int H, int KH, float scale_log2,
                            int causal, int window) {
  constexpr int BKV = kKvTile<DK>;
  constexpr int LDQ = DK + kPad;  // words between rows of the Q and K tiles
  constexpr int LDV = DV + kPad;  // and of the V tile
  constexpr int KS = DK / 8;      // k-steps of Q K^T
  constexpr int NT = BKV / 8;     // 8-key column tiles of S = k-steps of P V
  constexpr int DT = DV / 8;      // 8-dim column tiles of O
  static_assert(DV <= DK, "the output is staged through the Q buffer");
  static_assert(NT % 2 == 0, "K fragments come two key tiles at a time");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + 2 * BKV * LDQ;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;   // fragment row (and row + 8)
  const int quad = lane & 3;   // fragment column
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = q_tile * kBQ;
  const int a0 = q_offset + q0;  // absolute position of the tile's first row
  // this lane's rows, at absolute positions: arow0 and arow0 + 8
  const int arow0 = a0 + warp * 16 + grp;

  const size_t q_row = size_t(H) * DK;
  const size_t k_row = size_t(KH) * DK;
  const size_t v_row = size_t(KH) * DV;
  const float* qb = q + (size_t(b) * S * H + h) * DK;
  const float* kb = k + (size_t(b) * T_len * KH + kh) * DK;
  const float* vb = v + (size_t(b) * T_len * KH + kh) * DV;

  // KV tiles with at least one visible key for some row of this tile.
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, a0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = (max(0, a0 - window + 1) / BKV) * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  stage_tile<DK, kBQ>(Qs, qb, q_row, q0, S);
  if (n_tiles > 0) {
    stage_tile<DK, BKV>(Ks, kb, k_row, kv_begin, kv_len);
    stage_tile<DV, BKV>(Vs, vb, v_row, kv_begin, kv_len);
  }
  repro::cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max of the unscaled scores
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const float* Qw = Qs + warp * 16 * LDQ;  // this warp's 16 rows

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BKV;
    const float* Kt = Ks + (it & 1) * BKV * LDQ;
    const float* Vt = Vs + (it & 1) * BKV * LDV;
    repro::cp_async_wait<0>();  // tile it (and, at it = 0, Q) has landed
    // One barrier a tile: past it, every thread's copies of tile it are
    // visible, and every warp is done with tile it - 1, whose stage the
    // copy of tile it + 1 now fills while tile it is computed.
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      stage_tile<DK, BKV>(Ks + nxt * BKV * LDQ, kb, k_row, k0 + BKV, kv_len);
      stage_tile<DV, BKV>(Vs + nxt * BKV * LDV, vb, v_row, k0 + BKV, kv_len);
      repro::cp_async_commit();
    }

    // S = Q K^T: 16 rows x BKV keys per warp, each fragment split as it is
    // loaded.  The three products run over every key tile before the next
    // product starts, so consecutive mma are independent; big * big and the
    // two cross terms go to separate accumulators, summed at the end.
    float s[NT][4], s_lo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_lo[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4], qbig[4], qsml[4];
      repro::ldmatrix_x4(qf, Qw + (lane & 15) * LDQ + kk * 8 + (lane >> 4) * 4);
      repro::split_x4(qf, qbig, qsml);
      uint32_t kbig[NT / 2][4], ksml[NT / 2][4];  // key tiles 2 np and 2 np + 1
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ + kk * 8 +
                        ((lane >> 3) & 1) * 4;
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, Kt + off);
        repro::split_x4(kf, kbig[np], ksml[np]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        repro::mma_tf32_1688(s_lo[j], qsml, kbig[j / 2][(j & 1) * 2], kbig[j / 2][(j & 1) * 2 + 1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        repro::mma_tf32_1688(s_lo[j], qbig, ksml[j / 2][(j & 1) * 2], ksml[j / 2][(j & 1) * 2 + 1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        repro::mma_tf32_1688(s[j], qbig, kbig[j / 2][(j & 1) * 2], kbig[j / 2][(j & 1) * 2 + 1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_lo[j][e];

    // Mask only tiles that cross an edge.  Scores stay unscaled: the max is
    // taken on them and scale * log2(e) is folded into the exponent's FMA.
    const bool edge = k0 + BKV > kv_len || (causal && k0 + BKV - 1 > a0) ||
                      (window > 0 && k0 < a0 + kBQ - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * quad + (e & 1);
          const int apos = arow0 + (e >> 1) * 8;
          const bool ok = kpos < kv_len && (!causal || kpos <= apos) &&
                          (window <= 0 || kpos > apos - window);
          s[j][e] = ok ? s[j][e] : -INFINITY;
        }
    }

    // Online softmax on the fragment: this lane's rows (e = 0, 1 and e = 2, 3).
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
      const float corr = repro::ex2_approx(fmaf(m[r], scale_log2, -mu[r]));
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }
    // P as the A fragments of P V, one k-step per 8-key tile j.  The
    // accumulator gives this lane keys 2 quad and 2 quad + 1, where the A
    // fragment wants keys quad and quad + 4; the sum over keys takes them in
    // any order, so A column quad stands for key 2 quad and column quad + 4
    // for key 2 quad + 1, and V's B fragment reads rows 2 quad and
    // 2 quad + 1 to match.  No shuffle, no shared memory.
    uint32_t pbig[NT][4], psml[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = repro::ex2_approx(fmaf(s[j][0], scale_log2, -mu[0]));
      const float p1 = repro::ex2_approx(fmaf(s[j][1], scale_log2, -mu[0]));
      const float p2 = repro::ex2_approx(fmaf(s[j][2], scale_log2, -mu[1]));
      const float p3 = repro::ex2_approx(fmaf(s[j][3], scale_log2, -mu[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      repro::split_tf32(p0, pbig[j][0], psml[j][0]);  // (row grp, key 2 quad)
      repro::split_tf32(p2, pbig[j][1], psml[j][1]);  // (row grp + 8, key 2 quad)
      repro::split_tf32(p1, pbig[j][2], psml[j][2]);  // (row grp, key 2 quad + 1)
      repro::split_tf32(p3, pbig[j][3], psml[j][3]);  // (row grp + 8, key 2 quad + 1)
    }

    // O += P V: V's B fragment b0 = V[2 quad][8 d + grp], b1 = V[2 quad + 1][8 d
    // + grp] of the k-step's 8 keys, by scalar loads (ldmatrix.trans would
    // cut each f32 word in two), kDG output tiles at a time so that each
    // product runs over kDG independent accumulators.
    constexpr int kDG = DT % 4 == 0 ? 4 : 2;  // 2 at dv 80 (10 output tiles)
    static_assert(DT % kDG == 0, "whole groups of output tiles");
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int vrow = (j * 8 + 2 * quad) * LDV + grp;
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += kDG) {
        uint32_t vbig[kDG][2], vsml[kDG][2];
#pragma unroll
        for (int g = 0; g < kDG; ++g)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            repro::split_tf32(Vt[vrow + r * LDV + (d0 + g) * 8], vbig[g][r], vsml[g][r]);
#pragma unroll
        for (int g = 0; g < kDG; ++g)
          repro::mma_tf32_1688(acc[d0 + g], psml[j], vbig[g][0], vbig[g][1]);
#pragma unroll
        for (int g = 0; g < kDG; ++g)
          repro::mma_tf32_1688(acc[d0 + g], pbig[j], vsml[g][0], vsml[g][1]);
#pragma unroll
        for (int g = 0; g < kDG; ++g)
          repro::mma_tf32_1688(acc[d0 + g], pbig[j], vbig[g][0], vbig[g][1]);
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
  float* Ow = Qs + warp * 16 * LDQ;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<float2*>(Ow + grp * LDQ + d * 8 + 2 * quad) =
        make_float2(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<float2*>(Ow + (grp + 8) * LDQ + d * 8 + 2 * quad) =
        make_float2(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = DV / 4;  // 16-byte chunks of an output row
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < S)
      *reinterpret_cast<float4*>(o + ((size_t(b) * S + qpos) * H + h) * DV + c * 4) =
          *reinterpret_cast<const float4*>(Ow + r * LDQ + c * 4);
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int kv_len, int q_offset, int H, int KH, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  auto kern = flash_fwd_tf32x3_kernel<DK, DV>;
  // Set once per instance (a process drives one card), not on every call:
  // the shared memory above 48 KB, and the largest carveout, so that two
  // blocks fit an SM.
  static const cudaError_t attr_err = [kern] {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(o), S,
                                         T_len, kv_len, q_offset, H, KH,
                                         scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace tf32x3

// ---------------------------------------------------------------------------
// bf16: tensor cores.
namespace tensor_core {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;        // query rows per block
// Keys per KV tile: 64, and 32 at dk 256, where 64-key tiles would take
// 163,840 B (one block an SM) and spill beside the 128-register output
// accumulator; 32-key ones take 98,304 B, so two blocks fit an SM.
template <int DK>
constexpr int kKvTile = DK > 192 ? 32 : 64;
constexpr int kWarps = 4;      // each owns 16 query rows
constexpr int kThreads = kWarps * 32;

template <int DK, int DV>
constexpr size_t smem_bytes() {  // Q, 2 stages of K and of V
  return sizeof(bf16) * (size_t(DK) * (kBQ + 2 * kKvTile<DK>) + size_t(DV) * 2 * kKvTile<DK>);
}

// Element offset of 16-byte chunk c of row r in a (rows, HD) bf16 tile whose
// chunks are XOR-swizzled by row (common.cuh::swizzle_chunk): the 8 rows an
// ldmatrix reads land in 8 different bank groups.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + (repro::swizzle_chunk<HD / 8>(r, c) << 3);
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

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T_len,
                         int kv_len, int q_offset, int H, int KH, float scale_log2, int causal,
                         int window) {
  constexpr int kBKV = kKvTile<DK>;
  constexpr int KS = DK / 16;   // k-steps of Q K^T
  constexpr int NT = kBKV / 8;  // 8-key column tiles of S
  constexpr int DT = DV / 8;    // 8-dim column tiles of O
  static_assert(DV <= DK, "the output is staged through the Q buffer");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * DK;
  bf16* Vs = Ks + 2 * kBKV * DK;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;   // fragment row (and row + 8)
  const int quad = lane & 3;   // fragment column pair
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = q_tile * kBQ;
  const int a0 = q_offset + q0;  // absolute position of the tile's first row
  // this lane's rows, at absolute positions: arow0 and arow0 + 8
  const int arow0 = a0 + warp * 16 + grp;

  const size_t q_row = size_t(H) * DK;
  const size_t k_row = size_t(KH) * DK;
  const size_t v_row = size_t(KH) * DV;
  const bf16* qb = q + (size_t(b) * S * H + h) * DK;
  const bf16* kb = k + (size_t(b) * T_len * KH + kh) * DK;
  const bf16* vb = v + (size_t(b) * T_len * KH + kh) * DV;

  // KV tiles with at least one visible key for some row of this tile.
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, a0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = (max(0, a0 - window + 1) / kBKV) * kBKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBKV - 1) / kBKV : 0;

  stage_tile<DK, kBQ>(Qs, qb, q_row, q0, S);
  repro::cp_async_commit();
  if (n_tiles > 0) {
    stage_tile<DK, kBKV>(Ks, kb, k_row, kv_begin, kv_len);
    stage_tile<DV, kBKV>(Vs, vb, v_row, kv_begin, kv_len);
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
  // Q's A fragments, held in registers for the whole walk up to dk 128; at
  // dk 192 they would take 48 registers beside the 64 of the accumulator
  // and spill (at dk 256, 64 beside 128), so there each k-step reads its
  // fragment from the Q tile.
  constexpr bool kHoldQ = DK <= 128;
  uint32_t qf[kHoldQ ? KS : 1][4];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      repro::ldmatrix_x4(qf[kk], Qs + swz<DK>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kBKV;
    const bf16* Kt = Ks + (it & 1) * kBKV * DK;
    const bf16* Vt = Vs + (it & 1) * kBKV * DV;
    repro::cp_async_wait<0>();  // tile it has landed
    // One barrier a tile: past it, every thread's copies of tile it are
    // visible, and every warp is done with tile it - 1, whose stage the
    // copy of tile it + 1 now fills while tile it is computed.
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      stage_tile<DK, kBKV>(Ks + nxt * kBKV * DK, kb, k_row, k0 + kBKV, kv_len);
      stage_tile<DV, kBKV>(Vs + nxt * kBKV * DV, vb, v_row, k0 + kBKV, kv_len);
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
      if constexpr (!kHoldQ)
        repro::ldmatrix_x4(qf[0], Qs + swz<DK>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
      const uint32_t(&qa)[4] = qf[kHoldQ ? kk : 0];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];  // B fragments of key tiles 2 np and 2 np + 1
        repro::ldmatrix_x4(
            kf, Kt + swz<DK>(np * 16 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
        repro::mma_bf16_16816(s[2 * np], qa, kf[0], kf[1]);
        repro::mma_bf16_16816(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // Mask only tiles that cross an edge.  Scores stay unscaled: the max is
    // taken on them and scale * log2(e) is folded into the exponent's FMA.
    const bool edge = k0 + kBKV > kv_len || (causal && k0 + kBKV - 1 > a0) ||
                      (window > 0 && k0 < a0 + kBQ - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * quad + (e & 1);
          const int apos = arow0 + (e >> 1) * 8;
          const bool ok = kpos < kv_len && (!causal || kpos <= apos) &&
                          (window <= 0 || kpos > apos - window);
          s[j][e] = ok ? s[j][e] : -INFINITY;
        }
    }

    // Online softmax on the fragment: this lane's rows (e = 0, 1 and e = 2, 3).
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
        repro::ldmatrix_x4_trans(vf, Vt + swz<DV>(kk * 16 + (lane & 15), 2 * dp + (lane >> 4)));
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
    *reinterpret_cast<uint32_t*>(Qs + swz<DV>(r_lo, d) + 2 * quad) =
        repro::pack_bf16x2(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Qs + swz<DV>(r_lo + 8, d) + 2 * quad) =
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
      *reinterpret_cast<uint4*>(o + ((size_t(b) * S + qpos) * H + h) * DV + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<DV>(warp * 16 + r, c));
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int kv_len, int q_offset, int H, int KH, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  auto kern = flash_fwd_mma_kernel<DK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                         static_cast<const bf16*>(v), static_cast<bf16*>(o), S,
                                         T_len, kv_len, q_offset, H, KH,
                                         scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace tensor_core
}  // namespace

REPRO_EXPORT_ERROR_STRING

// Returns the CUDA error code of the launch (0 on success).  T_len is k's and
// v's length (their per-batch stride), kv_len <= T_len the number of visible
// keys, q_offset the absolute position of query row 0; hd is q's and k's
// head dim, hd_v v's and out's.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int T_len, int kv_len, int q_offset,
                                   int H, int KH, int hd, int hd_v, float scale, int causal,
                                   int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KH <= 0 || H % KH != 0 || kv_len < 0 || kv_len > T_len || q_offset < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DK, DV)                                                               \
  if (hd == DK && hd_v == DV) {                                                                \
    if (dtype == repro::kF32)                                                                  \
      return int(tf32x3::launch<DK, DV>(q, k, v, o, B, S, T_len, kv_len, q_offset, H, KH,      \
                                        scale, causal, window, st));                           \
    if (dtype == repro::kBF16)                                                                 \
      return int(tensor_core::launch<DK, DV>(q, k, v, o, B, S, T_len, kv_len, q_offset, H, KH, \
                                             scale, causal, window, st));                      \
  }
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(192, 128)
  REPRO_FLASH_CASE(96, 64)
  REPRO_FLASH_CASE(80, 80)
  REPRO_FLASH_CASE(256, 256)
#undef REPRO_FLASH_CASE
  return int(cudaErrorInvalidValue);
}
