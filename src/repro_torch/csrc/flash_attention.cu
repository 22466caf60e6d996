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
// 64) (minicpm3-4b: [nope 64 ‖ rope 32], values 64).  At dk 96 and 80 a
// bf16 row of 192 or 160 bytes is no multiple of the 128-byte swizzle span:
// the bf16 kernel splits it into TMA boxes (below).  At (256, 256) the
// output accumulator alone is 128 f32 registers a thread (64 query rows a
// warpgroup in bf16, 16 a warp in f32), and the f32 tiles take 133,120 B
// (16-key tiles: one block an SM).
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
//   * a loop inside the block walks KV tiles (the TPU's sequential `nkv`
//     grid axis), so the softmax state and the output accumulator stay in
//     registers, while the next tiles are in flight;
//   * the mask and the online softmax run on the accumulator fragments in
//     registers (exp2, with scale * log2(e) folded into its argument's
//     FMA; a row's max and sum reduce over the 4 lanes of a quad); the
//     per-element mask runs only on tiles that cross the diagonal, the
//     window edge or the end of the keys;
//   * P is already the A fragment of the P V product, so it never touches
//     shared memory;
//   * tiles above the causal diagonal or left of the window band are never
//     loaded, the grid starts with the heaviest (last) query tiles, and
//     ragged S and T are masked per element, so S need not be a multiple of
//     the tile (the TPU kernel requires it).
//
// bf16 -> `flash_fwd_wgmma_kernel`, on Hopper's own path (hopper.cuh):
//   * Block: 128 query rows of one (batch, query head), two warpgroups of
//     64 rows each; 256 threads.  Thread 0 is also the producer: it loads Q
//     once by TMA and keeps K and V tiles in flight in a ring of 3 stages (2
//     at (192, 128) and (256, 256), where 3 do not fit), a full and an empty
//     mbarrier a stage; it refills a stage once all 8 warps have released
//     it.  Warp 0 waits there only as long as the other warpgroup lags.
//   * Tensor maps: four-dimensional over the model layout, q (B, S, H, dk),
//     k and v (B, T, K, d), boxes of 64 columns with the 128-byte swizzle
//     and, at dk 80 / 96 and dv 80, a tail box of 16 or 32 columns with the
//     32- or 64-byte swizzle (a row of 160 or 192 bytes is no multiple of
//     128), each its own wgmma descriptor over its k-steps.  The sequence
//     extent of k's and v's maps is kv_len, their batch stride T: TMA fills
//     the rows at and past kv_len with zeros and never reads them (a slot
//     cache's stale tail in chunked prefill).  The host encodes the six maps
//     for each call through cuTensorMapEncodeTiled, looked up by
//     cudaGetDriverEntryPointByVersion (no libcuda link), and passes them as
//     __grid_constant__ parameters, so a CUDA graph captures them.
//   * S = Q K^T: wgmma m64nBNk16, Q and the K tile K-major in shared memory,
//     the f32 scores in registers; 128-key tiles (64 at dk 256).
//   * Softmax as above, but P's exponent s c - mu is rounded as the tiled
//     plain version rounds it (two roundings, exp2f; no FMA); P rounded to bf16 in registers
//     is the A operand of O += P V (wgmma from registers), and B is the V
//     tile MN-major as it lies, so nothing is transposed.
//   * One tile at a time within a warpgroup (S, wait, softmax, P V, wait);
//     the two warpgroups drift out of step, so one's softmax runs beside the
//     other's products.
//   * The output is staged through the Q tile (swizzled 16-byte chunks) and
//     stored as 16-byte rows; rows >= S are never written.
//   * Registers and shared memory by instance (nvcc 12.9, -Xptxas -v, no
//     spill in any): (64, 64) 155 registers, 115,776 B; (128, 128) 178,
//     230,464 B; (192, 128) 184, 214,080 B; (96, 64) 158, 148,544 B; (80,
//     80) 164, 144,448 B; (256, 256) 198, 197,696 B.  One block an SM.
//   * Measured and given up (NVIDIA H100 80GB HBM3 at 700 W, graph timer,
//     launch/flash_bench.py; PERF.md section 6): a producer warpgroup with
//     setmaxnreg (40 registers to it, 232 to the consumers, 384 threads):
//     ptxas held the consumers near the launch's 168 registers and spilled
//     28 B at (128, 128) and 248-968 B at (256, 256), and it was slower at
//     every case (gemma3 global 0.159 ms against 0.120); overlapping a tile's
//     softmax with the previous tile's P V inside a warpgroup (P double-
//     buffered): slower at every case (main 0.0696-0.0703 ms against
//     0.0670-0.0686, gemma3 global 0.148 against 0.113); ping-pong turns
//     between the warpgroups: no consistent gain.  ex2.approx.ftz on an
//     exponent taken by one FMA was ~5% faster (main 0.0670-0.0686 ms
//     against 0.0726-0.0749, separate calls); P's exponent is rounded as
//     the plain version's instead.
//   * What bounds it.  At the main case the kernel reaches a third of its
//     byte bound and about 30% of the tensor cores' rate: a warpgroup waits
//     for each product in turn, and the grid, one block an SM, ends in a
//     ragged last wave.  At the short bucket (B 8, S 128: one tile a block)
//     it is ~10% slower than the mma.sync kernel it replaced, which ran two
//     blocks an SM.  A persistent tile scheduler and GQA packing are the
//     ways on from here.
//
// f32 -> `flash_fwd_tf32x3_kernel`: one block of 4 warps per (64 query
//   rows, query head, batch), each warp owning 16 rows; K and V tiles in a
//   2-stage ring filled by 16-byte cp.async, behind one barrier a tile; the
//   output staged through the Q buffer.  Both products on the tensor cores as
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
#include <chrono>

#include "common.cuh"
#include "hopper.cuh"
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
// bf16: wgmma products fed by TMA from a producer warpgroup.
namespace wgmma_tc {

using bf16 = __nv_bfloat16;
namespace hw = repro::hopper;

constexpr int kBQ = 128;        // query rows a block
constexpr int kRows = 64;       // rows of a warpgroup (wgmma's M)
constexpr int kThreads = 256;   // two warpgroups; thread 0 also issues the loads
constexpr size_t kSmemLimit = 232448;  // shared memory a block can use
constexpr size_t kSmemSlack = 1024;    // to align the tiles to 1024 bytes
constexpr size_t kBarrierBytes = 64;   // the ring's and Q's mbarriers

// Keys a KV tile: 128, and 64 at dk 256, where the 64 x 256 output
// accumulator alone takes 128 registers a thread.
template <int DK>
constexpr int kKvTile = DK > 192 ? 64 : 128;
// Whether Q's descriptors are made opaque inside the walk (hw::opaque): one
// base held and each k-step's offset added where it is used, instead of
// every k-step's descriptor held in registers.  At dk 256 the held ones
// spill beside the 128-register output accumulator.
template <int DK>
constexpr bool kOpaqueQ = DK > 192;

// A head dimension D as TMA boxes: D / 64 boxes of 64 columns (128-byte rows,
// 128-byte swizzle), then a tail box of the D % 64 columns left (16: 32-byte
// rows and swizzle; 32: 64-byte).  A tile of R rows holds each box's R rows
// packed, one box after the other, so every box starts 1024-byte aligned.
template <int D>
struct Split {
  static constexpr int kChunks = D / 64;
  static constexpr int kTail = D % 64;
  static_assert(kChunks > 0 && (kTail == 0 || kTail == 16 || kTail == 32),
                "head dims of 64 n, 64 n + 16 or 64 n + 32");
  static constexpr int kTailLayout = kTail == 32 ? hw::kSwizzle64 : hw::kSwizzle32;
  static constexpr CUtensorMapSwizzle kTailSwizzle =
      kTail == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  // Descriptors of rows r0.. of a tile of R rows as a K-major operand: the
  // 64-column boxes (a k-step kk < 4 kChunks is kk / 4 boxes and kk % 4 32-
  // byte steps on), and the tail box (k-step 4 kChunks + t is t 32-byte
  // steps on).
  static __device__ __forceinline__ uint64_t kmajor(const bf16* tile, int r0) {
    return hw::smem_desc(tile + r0 * 64, 16, 8 * 128, hw::kSwizzle128);
  }
  template <int R>
  static __device__ __forceinline__ uint64_t kmajor_tail(const bf16* tile, int r0) {
    return hw::smem_desc(tile + kChunks * R * 64 + r0 * kTail, 16, 8 * kTail * 2, kTailLayout);
  }
  template <int R>
  static __host__ __device__ constexpr uint32_t kstep_bytes(int kk) {
    return kk < 4 * kChunks ? (kk / 4) * R * 128 + (kk % 4) * 32 : (kk - 4 * kChunks) * 32;
  }
  // A tile of R rows (keys) as the MN-major B operand of P V: the 64-column
  // boxes as one operand of N = 64 kChunks (boxes R x 128 bytes apart), the
  // 16-column tail as another; k-step kk (keys 16 kk ..) is 16 rows on.
  template <int R>
  static __device__ __forceinline__ uint64_t mnmajor(const bf16* tile) {
    return hw::smem_desc(tile, R * 128, 8 * 128, hw::kSwizzle128);
  }
  template <int R>
  static __device__ __forceinline__ uint64_t mnmajor_tail(const bf16* tile) {
    return hw::smem_desc(tile + kChunks * R * 64, R * kTail * 2, 8 * kTail * 2, kTailLayout);
  }
};

template <int DK, int DV, int ST>
constexpr size_t tile_bytes() {  // Q, then ST stages of K and of V
  return sizeof(bf16) * (size_t(kBQ) * DK + size_t(ST) * kKvTile<DK> * (DK + DV));
}
// Stages of the K / V ring: 3 where they fit, else 2.
template <int DK, int DV>
constexpr int kStages =
    kSmemSlack + tile_bytes<DK, DV, 3>() + kBarrierBytes <= kSmemLimit ? 3 : 2;
template <int DK, int DV>
constexpr size_t smem_bytes() {
  return kSmemSlack + tile_bytes<DK, DV, kStages<DK, DV>>() + kBarrierBytes;
}

// Producer: TMA loads of rows [row, row + R) of one head and batch into a
// tile of R rows, box by box; their bytes complete on `bar`.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* main,
                                          const CUtensorMap* tail, uint64_t* bar, int row,
                                          int head, int b) {
  using Sp = Split<D>;
#pragma unroll
  for (int c = 0; c < Sp::kChunks; ++c)
    hw::tma_load_4d(dst + c * R * 64, main, bar, c * 64, row, head, b);
  if constexpr (Sp::kTail > 0)
    hw::tma_load_4d(dst + Sp::kChunks * R * 64, tail, bar, Sp::kChunks * 64, row, head, b);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_q_tail,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_k_tail,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_v_tail, bf16* __restrict__ o,
                           int S, int kv_len, int q_offset, int H, int KH, float scale_log2,
                           int causal, int window) {
  constexpr int BN = kKvTile<DK>;
  constexpr int ST = kStages<DK, DV>;
  constexpr int NB = BN / 8;   // 8-key column blocks of S
  using SK = Split<DK>;
  using SV = Split<DV>;
  constexpr int NV = SV::kChunks * 64;  // columns of the main P V product
  constexpr int NTB = SV::kTail / 8;    // 8-column blocks of the tail's
  static_assert(SV::kTail == 0 || SV::kTail == 16, "value tails of 16 columns");
  static_assert(DV <= DK, "the output is staged through the Q tile");

  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Ks = Qs + kBQ * DK;
  bf16* Vs = Ks + ST * BN * DK;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + ST * BN * DV);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = q_tile * kBQ;
  const int a0 = q_offset + q0;  // absolute position of the block's first row

  // KV tiles with at least one visible key for some row of this block.
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, a0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = (max(0, a0 - window + 1) / BN) * BN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&full[s], 1);     // thread 0's arrive, plus the bytes
      hw::mbar_init(&empty[s], 8);    // one arrive from each warp
    }
    hw::mbar_init(qbar, 1);
    hw::mbar_init_fence();
  }
  __syncthreads();

  // Thread 0's loads: K and V of tile `it` into stage it % ST, and Q.
  auto load_kv = [&](int it) {
    const int st = it % ST;
    hw::mbar_arrive_expect_tx(&full[st], BN * (DK + DV) * sizeof(bf16));
    const int k0 = kv_begin + it * BN;
    load_tile<DK, BN>(Ks + st * BN * DK, &tm_k, &tm_k_tail, &full[st], k0, kh, b);
    load_tile<DV, BN>(Vs + st * BN * DV, &tm_v, &tm_v_tail, &full[st], k0, kh, b);
  };
  auto load_q = [&] {
    hw::mbar_arrive_expect_tx(qbar, kBQ * DK * sizeof(bf16));
    load_tile<DK, kBQ>(Qs, &tm_q, &tm_q_tail, qbar, q0, h, b);
  };

  // Thread 0 loads Q and the first ST tiles, then, once its warp is done
  // with tile `done`, refills that tile's stage with tile done + ST as soon
  // as every warp has released it.
  if (threadIdx.x == 0 && n_tiles > 0) {
    load_q();
    for (int it = 0; it < min(ST, n_tiles); ++it) load_kv(it);
  }
  auto refill = [&](int done) {
    if (threadIdx.x == 0 && done >= 0 && done + ST < n_tiles) {
      hw::mbar_wait(&empty[done % ST], (done / ST) & 1);
      load_kv(done + ST);
    }
  };

  // Warpgroup c owns block rows 64 c .. 64 c + 63.
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane >> 2;   // fragment row (and row + 8)
  const int quad = lane & 3;   // fragment column pair
  const int r0 = c * kRows;
  const int ac0 = a0 + r0;     // absolute position of the warpgroup's first row
  // this lane's rows, at absolute positions: arow0 and arow0 + 8
  const int arow0 = ac0 + warp * 16 + grp;
  const uint64_t q_desc = SK::kmajor(Qs, r0);
  const uint64_t q_tail_desc = SK::template kmajor_tail<kBQ>(Qs, r0);

  float acc[NV / 2], acc_t[NTB > 0 ? 4 * NTB : 1];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * NTB; ++i) acc_t[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max of the unscaled scores
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  // S = Q K^T of tile `it`: 64 rows x BN keys per warpgroup, into registers
  // (the first k-step drops s's old value), issued and committed as one
  // group, not waited for.
  auto issue_s = [&](float (&s)[BN / 2], int it) {
    const bf16* Kt = Ks + (it % ST) * BN * DK;
    const uint64_t qd = kOpaqueQ<DK> ? hw::opaque(q_desc) : q_desc;
    const uint64_t kd = SK::kmajor(Kt, 0);
#pragma unroll
    for (int kk = 0; kk < 4 * SK::kChunks; ++kk)
      hw::wgmma_ss<BN>(s, hw::desc_add(qd, SK::template kstep_bytes<kBQ>(kk)),
                       hw::desc_add(kd, SK::template kstep_bytes<BN>(kk)), kk > 0);
    if constexpr (SK::kTail > 0) {
      const uint64_t qtd = kOpaqueQ<DK> ? hw::opaque(q_tail_desc) : q_tail_desc;
      const uint64_t ktd = SK::template kmajor_tail<BN>(Kt, 0);
#pragma unroll
      for (int t16 = 0; t16 < SK::kTail / 16; ++t16)
        hw::wgmma_ss<BN>(s, hw::desc_add(qtd, 32 * t16), hw::desc_add(ktd, 32 * t16), 1);
    }
    hw::wgmma_commit();
  };
  // O += P V of tile `it`, V's tile read MN-major as it lies; one group.
  auto issue_pv = [&](const uint32_t (&pf)[BN / 16][4], int it) {
    const bf16* Vt = Vs + (it % ST) * BN * DV;
    const uint64_t vd = SV::template mnmajor<BN>(Vt);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      hw::wgmma_rs<NV>(acc, pf[kk], hw::desc_add(vd, kk * 16 * 128), 1);
      if constexpr (NTB > 0)
        hw::wgmma_rs<16>(acc_t, pf[kk],
                         hw::desc_add(SV::template mnmajor_tail<BN>(Vt), kk * 16 * SV::kTail * 2),
                         1);
    }
    hw::wgmma_commit();
  };
  // Pin the registers a wgmma reads before wgmma.fence: a register written
  // between two wgmma of a stage makes ptxas serialize them.
  auto pin_out = [&] {
    hw::fence_operands(acc);
    if constexpr (NTB > 0) hw::fence_operands(acc_t);
  };
  auto pin_p = [&](uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hw::fence_operands(pf[kk]);
  };
  // The online softmax of tile `it` on its score fragment: the running max
  // and sum, the factor `corr` that rescales the rows' output so far (this
  // lane's rows: e = 0, 1 and e = 2, 3), and P rounded to bf16 pairs as the
  // A fragment of P V (column blocks 2 kk and 2 kk + 1 make k-step kk); the
  // row sums are taken before rounding.  `rescale` applies `corr` to the
  // output.
  auto softmax = [&](float (&s)[BN / 2], int it, uint32_t (&pf)[BN / 16][4],
                     float (&corr)[2]) {
    const int k0 = kv_begin + it * BN;
    // Mask only tiles that cross an edge.  Scores stay unscaled: the max is
    // taken on them and scale * log2(e) is folded into the exponent's FMA.
    const bool edge = k0 + BN > kv_len || (causal && k0 + BN - 1 > ac0) ||
                      (window > 0 && k0 < ac0 + kRows - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * quad + (e & 1);
          const int apos = arow0 + (e >> 1) * 8;
          const bool ok = kpos < kv_len && (!causal || kpos <= apos) &&
                          (window <= 0 || kpos > apos - window);
          s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // P = 2^(s c - mu), c = scale log2(e), rounded as the tiled plain version
    // rounds it: s c and mu = max(s) c each rounded to f32, their difference
    // rounded, then exp2f (no FMA), so that P's rounding to bf16 differs from
    // the plain version's only where the scores do.
    float mu[2];  // the row max in the log2 domain
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no key seen yet: p = 0, not NaN
      mu[r] = m_new == -INFINITY ? 0.f : __fmul_rn(m_new, scale_log2);
      corr[r] = exp2f(__fsub_rn(__fmul_rn(m[r], scale_log2), mu[r]));
      m[r] = m_new;
      l[r] *= corr[r];
    }
    auto p_of = [&](float x, float u) { return exp2f(__fsub_rn(__fmul_rn(x, scale_log2), u)); };
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float p0 = p_of(s[4 * j], mu[0]);
      const float p1 = p_of(s[4 * j + 1], mu[0]);
      const float p2 = p_of(s[4 * j + 2], mu[1]);
      const float p3 = p_of(s[4 * j + 3], mu[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = repro::pack_bf16x2(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = repro::pack_bf16x2(p2, p3);
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < NV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_t[4 * j + e] *= corr[e >> 1];
  };
  // This warp is done with the stage of tile `it`: one arrive of the 8.
  auto release = [&](int it) {
    if (lane == 0) hw::mbar_arrive(&empty[it % ST]);
  };

  if (n_tiles > 0) {
    // One tile at a time: S, softmax, then P V.  The two warpgroups run
    // out of step, so one's softmax overlaps the other's products.
    float s[BN / 2], corr[2];
    uint32_t pf[BN / 16][4];
    hw::mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      hw::mbar_wait(&full[it % ST], (it / ST) & 1);
      hw::fence_operands(s);
      hw::wgmma_fence();
      issue_s(s, it);
      refill(it - 1);
      hw::wgmma_wait<0>();
      hw::fence_operands(s);
      softmax(s, it, pf, corr);
      rescale(corr);
      pin_out();
      pin_p(pf);
      hw::wgmma_fence();
      issue_pv(pf, it);
      hw::wgmma_wait<0>();
      pin_out();
      release(it);
    }
  }
  // Epilogue: once both warpgroups are past their last product nothing reads
  // Q, so its tile takes the output, rows XOR-swizzled by 16-byte chunk
  // (common.cuh::swizzle_chunk); each warpgroup writes and reads back only
  // its rows, stored as 16-byte rows; rows >= S are never written.
  hw::fence_proxy_async();  // wgmma's reads of Q before the writes below
  hw::named_sync(1, 2 * 128);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // fully masked row -> 0
  }
  constexpr int DT = DV / 8;  // 16-byte chunks of an output row
  const int r_lo = r0 + warp * 16 + grp;
  // column block j of the output, (a0, a1) of row r_lo and (a2, a3) of r_lo + 8
  auto stage = [&](int j, float a0, float a1, float a2, float a3) {
    *reinterpret_cast<uint32_t*>(Qs + r_lo * DV + (repro::swizzle_chunk<DT>(r_lo, j) << 3) +
                                 2 * quad) = repro::pack_bf16x2(a0 * inv[0], a1 * inv[0]);
    *reinterpret_cast<uint32_t*>(Qs + (r_lo + 8) * DV +
                                 (repro::swizzle_chunk<DT>(r_lo + 8, j) << 3) + 2 * quad) =
        repro::pack_bf16x2(a2 * inv[1], a3 * inv[1]);
  };
#pragma unroll
  for (int j = 0; j < NV / 8; ++j)
    stage(j, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
#pragma unroll
  for (int j = 0; j < NTB; ++j)
    stage(NV / 8 + j, acc_t[4 * j], acc_t[4 * j + 1], acc_t[4 * j + 2], acc_t[4 * j + 3]);
  hw::named_sync(2 + c, 128);
#pragma unroll
  for (int i = 0; i < kRows * DT / 128; ++i) {
    const int idx = i * 128 + t;
    const int r = r0 + idx / DT;
    const int ch = idx % DT;
    const int qpos = q0 + r;
    if (qpos < S)
      *reinterpret_cast<uint4*>(o + ((size_t(b) * S + qpos) * H + h) * DV + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * DV + (repro::swizzle_chunk<DT>(r, ch) << 3));
  }
}

// cuTensorMapEncodeTiled, looked up by cudaGetDriverEntryPointByVersion so
// that the library need not link libcuda; null when the lookup fails.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return e == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The maps of a (B, rows_alloc, NH, D) bf16 tensor seen as (B, rows, NH, D)
// (rows <= rows_alloc: TMA zero-fills the rest): maps[0] of 64-column boxes,
// maps[1] of the tail's (a copy of maps[0] when D has none), boxes of
// `box_rows` rows at one head and one batch.
template <int D>
cudaError_t make_maps(CUtensorMap (&maps)[2], const void* base, int B, int rows, int rows_alloc,
                      int NH, int box_rows) {
  using Sp = Split<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(NH), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(NH) * D * sizeof(bf16), cuuint64_t(D) * sizeof(bf16),
                                 cuuint64_t(rows_alloc) * NH * D * sizeof(bf16)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  for (int i = 0; i < (Sp::kTail > 0 ? 2 : 1); ++i) {
    const cuuint32_t box[4] = {cuuint32_t(i == 0 ? 64 : Sp::kTail), cuuint32_t(box_rows), 1, 1};
    const CUresult r =
        encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
               strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
               i == 0 ? CU_TENSOR_MAP_SWIZZLE_128B : Sp::kTailSwizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  if constexpr (Sp::kTail == 0) maps[1] = maps[0];
  return cudaSuccess;
}

// The six maps of one call: q over its S rows; k and v over their first
// kv_len rows of T_len, so rows at and past kv_len (a slot cache's stale
// tail) arrive as zeros and are never read.  With no visible key nothing is
// loaded, and k's and v's maps are copies of q's.
template <int DK, int DV>
cudaError_t make_call_maps(CUtensorMap (&mq)[2], CUtensorMap (&mk)[2], CUtensorMap (&mv)[2],
                           const void* q, const void* k, const void* v, int B, int S, int T_len,
                           int kv_len, int H, int KH) {
  cudaError_t e = make_maps<DK>(mq, q, B, S, S, H, kBQ);
  if (e != cudaSuccess || kv_len == 0) {
    mk[0] = mk[1] = mv[0] = mv[1] = mq[0];
    return e;
  }
  e = make_maps<DK>(mk, k, B, kv_len, T_len, KH, kKvTile<DK>);
  if (e != cudaSuccess) return e;
  return make_maps<DV>(mv, v, B, kv_len, T_len, KH, kKvTile<DK>);
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                   int kv_len, int q_offset, int H, int KH, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  static_assert(smem <= kSmemLimit, "tiles fit a block's shared memory");
  auto kern = flash_fwd_wgmma_kernel<DK, DV>;
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr_err != cudaSuccess) return attr_err;
  CUtensorMap mq[2], mk[2], mv[2];
  const cudaError_t e = make_call_maps<DK, DV>(mq, mk, mv, q, k, v, B, S, T_len, kv_len, H, KH);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(mq[0], mq[1], mk[0], mk[1], mv[0], mv[1],
                                         static_cast<bf16*>(o), S, kv_len, q_offset, H, KH,
                                         scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace wgmma_tc
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
      return int(wgmma_tc::launch<DK, DV>(q, k, v, o, B, S, T_len, kv_len, q_offset, H, KH,    \
                                          scale, causal, window, st));                         \
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

// Host microseconds that encoding one bf16 call's six tensor maps takes, the
// mean over `iters` encodes of the maps of q (B, S, H, hd), k (B, T_len, KH,
// hd) and v (B, T_len, KH, hd_v) with kv_len = T_len; negative when (hd,
// hd_v) has no bf16 kernel or an encode fails.
extern "C" double flash_attention_map_encode_us(const void* q, const void* k, const void* v,
                                                int B, int S, int T_len, int H, int KH, int hd,
                                                int hd_v, int iters) {
  CUtensorMap mq[2], mk[2], mv[2];
  cudaError_t (*make)(CUtensorMap(&)[2], CUtensorMap(&)[2], CUtensorMap(&)[2], const void*,
                      const void*, const void*, int, int, int, int, int, int) = nullptr;
#define REPRO_FLASH_MAPS(DK, DV) \
  if (hd == DK && hd_v == DV) make = wgmma_tc::make_call_maps<DK, DV>;
  REPRO_FLASH_MAPS(128, 128)
  REPRO_FLASH_MAPS(64, 64)
  REPRO_FLASH_MAPS(192, 128)
  REPRO_FLASH_MAPS(96, 64)
  REPRO_FLASH_MAPS(80, 80)
  REPRO_FLASH_MAPS(256, 256)
#undef REPRO_FLASH_MAPS
  if (make == nullptr || iters <= 0) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (make(mq, mk, mv, q, k, v, B, S, T_len, T_len, H, KH) != cudaSuccess) return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
