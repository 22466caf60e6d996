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
// (B, max_pages) int32, seq_lens (B,) int32, out (B, H, hd); f32 or bf16;
// hd 64, 128, 80 (h2o-danube-1.8b) or 256 (gemma3-4b, recurrentgemma-9b);
// G = 1, 2, 4, 8 or 16.  A sliding-window
// layer's ring cache (B, W, K, hd) is passed as pages too, with seq_len =
// min(pos + 1, W): keys are stored after RoPE, so the order of the ring's
// rows does not matter, and the kernel needs no window.
// Absorbed MLA decode runs split kernels of its own (see below:
// `paged_mla_mma_kernel` for bf16, `paged_mla_tf32x3_kernel` for f32): one
// KV head whose rows are keys and, in their first columns, values.
// deepseek-v2-lite: keys of 576 (latent 512 ‖ rope 64), values 512, groups
// of 16 (or 4) query heads; minicpm3-4b: keys of 288 (latent 256 ‖ rope
// 32), values 256, 40 query heads.
//
// What bounds it on this card: bytes.  Each cached token's K and V row is
// used for 2 * G * hd FLOPs per 4 * hd bytes (bf16), far below the H100's
// ~295 FLOP/byte ridge, so the floor is the KV bytes over 3.35 TB/s.  To
// reach it the card needs thousands of loads in flight at once, whatever
// the batch's lengths.  Three kernels, chosen by type and group: G = 1
// (llama2's MHA) runs `paged_split_kernel` on the CUDA cores in both types;
// G >= 2 runs the tensor cores, bf16 `paged_gqa_mma_kernel` and f32 its
// 3xTF32 twin `paged_gqa_tf32x3_kernel` (below).  What the split kernel's
// design does about the bytes:
//   * split the sequence: `paged_split_kernel` runs one block per (KV head,
//     sequence, partition of `partition` tokens; the wrapper passes 256), so
//     a long sequence is walked by many blocks at once and the call no
//     longer lasts as long as one block's walk of the longest sequence.  The
//     wrapper sets the partition size and the number of partitions from the
//     block table's width (no read of seq_lens, so no host sync); a block
//     whose partition starts at or past seq_len writes an empty partial and
//     exits;
//   * each block reads its own block-table entries;
//   * every load is 16 bytes a lane: a token's K (or V) row is read by
//     hd * sizeof(T) / 16 neighbouring lanes, and each lane keeps 8 (f32 at
//     hd 128) or 4 loads of K and as many of V in flight before using them;
//     a row of 80 takes 10 (bf16) or 20 (f32) lanes of a group of 16 or 32,
//     the rest idle, and an f32 row of 256 takes two loads a lane;
//   * each lane runs its own online softmax over the tokens it loaded; the
//     lanes' states merge by shuffles, the warps' through shared memory;
//   * the block writes (max, sum, unnormalised output) per (sequence, query
//     head, partition) to f32 scratch the wrapper allocated, and
//     `paged_merge_kernel` (one block per (sequence, query head)) rescales
//     and sums them.  With a single partition the split kernel normalises
//     and writes the output itself, and no merge is launched.
// Scores live in the log2 domain (q is pre-scaled by scale * log2(e)).
//
// Grouped bf16 -> `paged_gqa_mma_kernel<HD, G>`, tensor cores (replaces the
// same TPU kernel, `paged_attention_kernel`, kernel.py:75, at G >= 2).  A
// cached token's K and V rows (4 * HD bytes) serve 2 * G * 2 * HD FLOPs:
// at most 16 a byte, so bytes bound it; on the CUDA-core split kernel the
// in-block work bound it instead: at hd 256 a row spans the warp's 32 lanes
// and every score of every head took 5 shuffles, at G = 16 each row was
// read by two head tiles, and 255 registers held 8 loads in flight.  It
// takes the design of `paged_mla_mma_kernel` (below), with values in pages
// of their own:
//   * one block of 4 warps per (KV head, sequence, partition of
//     `GQA_PARTITION` tokens, ops.py); the group's G heads are the rows of
//     the m16n8k16 M tile, rows >= G zero and never written back, so at G =
//     16 each K and V row is read once for all 16 heads.  Q is staged once,
//     bf16 and unscaled; scale * log2(e) multiplies the f32 scores.  Up to
//     hd 128 Q's A fragments are held in registers over the walk;
//   * 32-token tiles of K and of V are copied from their pages by 16-byte
//     cp.async into a 2-stage ring (2 * 32 * 2 * HD bytes a stage: 32 KB at
//     hd 256); a row's page is looked up once for its K and V copies; rows
//     past seq_len are zero-filled and never read.  Rows are XOR-swizzled
//     by 16-byte chunk (rows of 80 take the swizzle's 2-chunk tail), so
//     every ldmatrix is free of bank conflicts;
//   * S = Q K^T: warp w owns the tile's tokens 8w..8w+7 over all HD / 16
//     k-steps (5 at hd 80: the last by a half ldmatrix), K's B fragments by
//     ldmatrix from the row-major tile;
//   * online softmax in f32 per head in the log2 domain on the fragments,
//     every max by fmax_nan: a head's tile max over the quad, then over the
//     4 warps through shared memory (one barrier), so every warp rescales
//     by the same max and P is rounded to bf16 against the tile's max, as
//     `paged_attention_tiled_ref` rounds it; the sum takes P unrounded;
//   * O += P V over the warp's own 8 tokens and all HD columns by m16n8k8:
//     the scores' accumulator layout is that product's A fragment, so P
//     never leaves registers (the MLA kernel passes it through shared
//     memory, a third barrier a tile); V's B fragments are ldmatrix.trans
//     of the staged rows.  Each warp holds a 16 x HD accumulator (128
//     registers at hd 256);
//   * after the walk the ring's space takes the 4 warps' outputs, summed in
//     warp order with their sums (one max for all of them, so no
//     rescaling), and the block writes the (max, sum, output) partials that
//     `paged_merge_kernel` merges, or with a single partition the output.
//   What bounds it as built (PERF.md section 6): not the bytes; latency.
//   At 128-token partitions (faster than 64 and 256 in sum over the
//   serves' cases) it beats SDPA at every bf16 group, and G = 16 at hd 256
//   runs at 0.94x SDPA, but 3.3x (8 full rings) to 23x (one long slot
//   among short ones) its byte bound.  A block keeps 2 stages (64 KB at hd
//   256) in flight, and a partition's walk is a chain of them: ~1.6 us a
//   32-token tile beyond the fourth (256-token partitions, fewer blocks
//   than SMs at one KV head, are 40% slower); below that the fixed costs
//   set the time: the launch, the first tile's copy behind the table
//   lookup, the epilogue's sum through shared memory, and the merge pass
//   (15-28% of the call).  A deeper ring or a second block an SM for
//   the full rings, and the merge folded into the split pass, are the way
//   to the bound.  245 registers at hd 256 (G only pads the M tile), 156
//   at 128, 124 at 80, 98 at 64; no spill.
//
// Grouped f32 -> `paged_gqa_tf32x3_kernel<HD, G>`, the bf16 kernel's twin
// (the same TPU kernel at G >= 2, f32).  The bytes double and the products
// triple: a K and V row (8 * HD bytes) serve 2 * G * 2 * HD FLOPs, each
// multiply taken as three TF32 products (big * big + big * small + small *
// big of operands split by warp_mma.cuh::split_tf32, as
// `paged_mla_tf32x3_kernel` takes them), so bytes still bound it; on the
// CUDA-core split kernel it replaces, the in-block work did (every score
// summed over a row's lanes by shuffles, at G = 16 two head tiles each
// reading every row, 255 registers and a spill).
// `paged_attention_tiled_ref` with `tf32_products=3` rounds exactly what it
// rounds.  The bf16 kernel's grid (KV head, sequence, partition of
// `GQA_PARTITION` tokens, ops.py), M tile of the G heads (rows >= G
// zero, never written back: G = 16 reads each row once), 2-stage ring of
// K and V tiles (f32 rows of HD / 4 chunks; 80 takes the swizzle's 4-chunk
// tail), page lookup, sum of the outputs and merge; what differs:
//   * 8 warps a block, NS = 8 / NG of them for each of the NG 8-token
//     groups of a tile: warp (group, slice) takes a slice of S's k-steps
//     for the group's tokens and the same slice of P V's output columns.
//     Tiles are 32 tokens (NS = 2), and 16 at hd 256 (NS = 4), where the
//     32-token ring leaves room for one block an SM;
//   * Q is loaded before seq_len is read, split once into TF32 big and
//     small planes in shared memory (2 x 16 x HD f32; 32 KB at hd 256), and
//     its A fragments come by ldmatrix (b16) from the planes at each k-step,
//     or at hd 64 once into registers;
//   * S: K's B fragments of two k-steps come by one ldmatrix (b16) from the
//     row-major f32 tile (an 8x8 b16 matrix is 8 rows of 4 words), of an odd
//     last one (hd 80: 5 k-steps a warp) by a half one, split as loaded;
//     big * big and the cross terms go to accumulators of their own.  Each
//     warp writes its partial scores to shared memory, and after the tile's
//     second barrier every warp sums the slices of every group in the same
//     order: each then takes the tile's max itself (no exchange), and P of
//     its own group.  Two barriers a tile, as in the bf16 kernel;
//   * scale * log2(e) multiplies the scores after the product, exp2 is
//     ex2.approx.ftz; the sum takes P unsplit;
//   * O += P V, one m16n8k8 k-step: P's A fragment takes the lane's tokens
//     2 quad and 2 quad + 1 as its columns quad and quad + 4, so it comes
//     from the scores' accumulator layout with no shuffle (as in the MLA
//     kernel), and V's B fragments are scalar loads of rows 2 quad and
//     2 quad + 1 against the swizzle (conflict-free but for the 4-chunk tail
//     at hd 80, two-way), split as loaded; HD / (2 NS) accumulator
//     registers a thread;
//   * shared memory (Q's planes, 2 stages of K and V, the partial scores):
//     45,312 B at hd 64, 55,552 at 80, 86,272 at 128 and 102,528 at 256,
//     so two blocks an SM fit at every width, each thread at most 128
//     registers (121, 120, 125 and 127 as built; no spill);
//   * zero-filled rows past seq_len score 0, are masked to -inf and give p
//     = 0 against V = 0.  A NaN in Q stays in its head: the split keeps it
//     in the small part, every max is max.NaN, and the M tile's other rows
//     never read that row of Q.
//   What bounds it as built (NVIDIA H100 80GB HBM3 at 700 W, graph timer;
//   PERF.md section 6): not the bytes; the in-block work of each tile, as
//   for the bf16 kernel.  A block of 4 warps, each all of a group's work,
//   ran one warp a scheduler at hd 256 (one block an SM): ~4.6 us a 32-token
//   tile, as fast with 3 stages in flight as with 2, and 4 slower where it
//   cost a block an SM; 8 warps took it to ~3.1 us, 16-token tiles at hd
//   256 to two blocks an SM.  At 128-token partitions (faster than 64 and
//   256 summed over chip_smoke.py's nine f32 cases) it runs 1.2-2.5x faster
//   than the split kernel everywhere but gemma3-4b's global G = 2 slots,
//   8% slower there.
//
// MLA (dk 576 = latent 512 ‖ rope 64, dv 512, one KV head, G = H / K of 16
// or 4).  A token's 1,152-byte bf16 row serves as key and, in its first 512
// columns, as value for all G heads: 2 * G * (576 + 512) FLOPs a row, ~30 a
// byte at G = 16.  That is still far under the tensor cores' ~295 FLOP/byte
// ridge, so bytes bound the bf16 kernel.  In f32 the bytes double, and the
// products taken as three TF32 products each (494.7 / 3 TFLOP/s) still sit
// under them: 2.0 us of products against 6.5 us of bytes at the serve's
// main case, where the CUDA cores (67 TFLOP/s, every FMA reading shared
// memory) would need 4.8 us.  minicpm3-4b's (288, 256) rows are half as
// wide and serve 40 heads, three M tiles of 16 (16, 16 and 8 live rows):
// each head tile is a block of its own along the grid's first axis, which
// re-reads its slot's rows (from L2, mostly).  Two kernels, chosen by
// type, on one grid and one ring:
//
// bf16 -> `paged_mla_mma_kernel`, tensor cores.  One block of 4 warps per
// (KV head, sequence, partition); the wrapper passes partitions of
// `MLA_PARTITION` = 128 tokens (ops.py; 64 times slower on the card, as
// chip_smoke.py shows: at 64 the merge reads twice the partials and the
// blocks of long sequences share SMs).
//   * Q is staged once, bf16 and unscaled (G x 576, 18 KB); its 16 rows are
//     the M tile of m16n8k16, rows >= G zero (G = 4) and never written back.
//     scale * log2(e) multiplies the f32 scores after the product, so no
//     rounding of a pre-scaled Q enters;
//   * 32-token tiles of latent rows are copied as they lie in device memory
//     (bf16, 36 KB a tile) by 16-byte cp.async into a 2-stage ring: both
//     stages go out before the first product, and tile i + 2 follows as
//     soon as tile i is done.  Each row's page comes from the block's own
//     block-table entries; rows past seq_len are zero-filled and never read
//     from device memory.  Rows are XOR-swizzled by 16-byte chunk (as in
//     flash_attention.cu), so every ldmatrix below is free of bank
//     conflicts;
//   * S = Q K^T: warp w owns the tile's tokens 8w..8w+7 (one n8 column
//     tile) over all 36 k-steps; K's B fragments come by ldmatrix from the
//     row-major tile (a row-major K is the column-major B operand); four
//     accumulators taken in turn keep four MMAs in flight;
//   * online softmax in f32 per head in the log2 domain on the fragments:
//     a head's tile max reduces over the quad, then over the 4 warps through
//     shared memory, so every warp rescales by the same max; each warp keeps
//     the sum of its own tokens (summed across warps once, at the end);
//   * P, rounded to bf16, goes through shared memory to every warp, and
//     O += P V runs with warp w owning output columns 128w..128w+127 (64 f32
//     accumulators a thread); V's fragments are ldmatrix.trans of the same
//     staged rows, so nothing is read twice from device memory;
//   * three barriers a tile (tile landed, tile max, P written); ~92 KB of
//     shared memory, so two blocks fit an SM: the serve's grid (8 slots x
//     16 partitions) runs in one wave, and so would 64-token partitions.
//   What bounds it as built: not the bytes.  On the card (PERF.md section
//   6) the split pass took as long with 3 or 4 stages in flight as with 2,
//   so the in-block work of each tile sets the time (four warps, one a
//   sub-partition, each MMA waiting on its ldmatrix; Q's fragments re-read
//   from shared memory every tile), and the merge takes about a third of
//   the whole.  More warps a block, Q held in registers, wgmma with the
//   tile's tokens as its 64 rows, and a merge folded into the split pass
//   are the way to the byte bound.
// f32 -> `paged_mla_tf32x3_kernel`: both products on the tensor cores as
//   mma.sync m16n8k8 with TF32 inputs, three products a multiply (big * big
//   + big * small + small * big of operands split by
//   warp_mma.cuh::split_tf32, as flash_attention.cu's f32 kernel takes
//   them), so it holds f32 to its plain version's limit (1e-4), where one
//   TF32 product would not; `paged_attention_tiled_ref` with `tf32_products=3`
//   rounds exactly what it rounds.  The bf16 kernel's grid, partitions,
//   M tile and ring (f32 rows of 2,304 B: 147,456 B for two 32-token
//   stages; rows past seq_len zero-filled, never read), with DK / 72 warps
//   (8 at 576, 4 at 288):
//   * S = Q K^T: warp w takes k-steps 9w..9w+8 (72 of the key dims) for
//     all 32 tokens of a tile.  Its Q A fragments for those k-steps are
//     loaded from device memory once, split once and held in registers (72
//     of them) over the whole partition: Q is never re-read or re-split.
//     K's B fragments of two token tiles come by one ldmatrix.x4 (b16) from
//     the row-major f32 tile (an 8x8 b16 matrix is 8 rows of 4 words) and
//     are split as they are loaded; each product runs over the 4 token
//     tiles before the next starts.
//   * The warps' partial sums are reduce-scattered (thread i adds the
//     i-th float2, or float4 at 4 warps, over the warps' shares, in warp
//     order) and gathered back through shared memory (18 KB at 8 warps):
//     three barriers a tile.  Every warp
//     then runs the same online softmax (the bf16 kernel's, scale *
//     log2(e) applied after the product, ex2.approx) over all 32 tokens,
//     so the max needs no exchange and P goes from the scores straight into
//     this warp's A fragments of P V (this lane's keys 2 quad and 2 quad + 1
//     of token tile n stand for the columns quad and quad + 4 of k-step n).
//   * O += P V: warp w owns output columns 64w..64w+63.  V's B fragments
//     are scalar loads of rows 2 quad and 2 quad + 1 of the same staged
//     tile, split as loaded.  The XOR swizzle serves both readers without
//     bank conflicts: K's ldmatrix rows fall in 8 chunk positions; for V
//     the chunk (16 w + 2 d + grp / 4) ^ (row & 7) takes 8 positions over
//     (grp / 4, quad) and grp % 4 picks the word.
//   * The block's table entries for its first two tiles and Q's loads go
//     out before seq_len is read, so the first copies wait for one load of
//     device memory, not two.
//   * 165,888 B of shared memory (one block an SM), 204 registers at G =
//     16 (247 at G = 4), no spill; at (288, 256, 40) 83,968 B and 199
//     registers.
//   * Zero-filled rows give scores of 0, masked to -inf, so p = 0 and V = 0:
//     no 0 * inf.  A NaN in Q or in a visible row reaches the output: the
//     TF32 split keeps it in the small part, the running max is max.NaN (so
//     a NaN partial is never taken for an empty one) and the merge passes a
//     NaN sum on.
//   What bounds it as built (PERF.md section 6): not the bytes and not the
//   tensor cores' rate.  A partition's walk is ~5 us fixed (the first
//   tile's copy behind the table lookup, Q, the epilogue) and ~3.2 us a
//   32-token tile, in which the S products keep the tensor pipe about half
//   busy and P V about 60%; the merge adds ~4.6 us.  Timed beside it on
//   the card and not kept (split pass of one full partition): the bf16
//   kernel's block of 4 warps with Q split once into big and small planes
//   in shared memory and P through shared memory, ~20% slower; the same
//   with Q split at each load, a further 22% (and spilling); 8 warps
//   reading Q's planes, 6-8%; the next k-step's K and V fragments loaded
//   before the products, no gain.  64-token partitions: ~25% slower on the
//   serve's main case, ~15% faster with one long slot among short ones.
// Both write the partials above (the merge runs dv threads), or with a
// single partition the output itself.
#include "common.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 4;

// max(a, b) that is NaN when either is (max.NaN.f32): a NaN score keeps the
// running max, and so the partial's max, NaN, so neither the warps' merge nor
// `paged_merge_kernel` takes the partial for an empty one.  For finite
// inputs it is fmaxf.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// G query heads a block: block x of the grid's first axis takes query heads
// x * G .. x * G + G - 1 of its sequence, of KV head x * G / (H / KH).
// Launched at G = 1 alone (`launch_split`): groups of 2 or more take the
// tensor-core kernels below.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens, T* __restrict__ o,
                       float* __restrict__ part, int H, int KH, int page, int max_pages,
                       int partition, int n_split, float scale_log2) {
  constexpr int EPL = 16 / sizeof(T);   // elements of one 16-byte load
  // 16-byte loads a lane takes of one row: 2 for f32 rows of 256, else 1
  constexpr int NV = HD > 32 * EPL ? HD / (32 * EPL) : 1;
  constexpr int EPT = NV * EPL;         // elements of a row a lane holds
  constexpr int LPT = HD / EPT;         // lanes that hold one token's row
  // Lanes a token takes: LPT rounded up to a power of 2, the lanes past LPT
  // idle (hd 80: 10 of 16 in bf16, 20 of 32 in f32), so that the lanes of a
  // token reduce by XOR shuffles.
  constexpr int LPW = LPT <= 4 ? 4 : LPT <= 8 ? 8 : LPT <= 16 ? 16 : 32;
  constexpr int TPW = 32 / LPW;         // tokens one warp-wide load covers
  constexpr int NL = (TPW >= 2 ? 4 : 8) / NV;  // loads of K (and of V) a lane keeps in flight
  constexpr int U = NL * TPW;           // tokens a warp takes per step
  static_assert(HD % EPT == 0 && LPT >= 1 && LPT <= 32, "a token row spans at most a warp");

  const int kh = blockIdx.x * G / (H / KH);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int B = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int seq_len = seq_lens[b];
  const int t_begin = split * partition;
  const int t_end = min(seq_len, t_begin + partition);
  const size_t bh0 = size_t(b) * H + size_t(blockIdx.x) * G;  // first query head of the tile
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

  const int sub = lane / LPW;                 // token of a warp-wide load
  const bool live = lane % LPW < LPT;         // this lane holds dims of the row
  const int d0 = live ? (lane % LPW) * EPT : 0;   // this lane's first dim
  float qr[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float part_q[EPL];
      repro::load_f32<T, EPL>(q + (bh0 + g) * HD + d0 + v * EPL, part_q);
#pragma unroll
      for (int i = 0; i < EPL; ++i) qr[g][v * EPL + i] = live ? part_q[i] * scale_log2 : 0.f;
    }
  }
  float m[G], l[G], acc[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[g][i] = 0.f;
  }

  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * HD;
  const size_t page_stride = size_t(page) * tok_stride;
  const size_t lane_off = size_t(kh) * HD + d0;

  for (int t0 = t_begin + w * U; t0 < t_end; t0 += kWarps * U) {
    uint4 kr[NL][NV], vr[NL][NV];
    bool ok[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = t0 + i * TPW + sub;
      ok[i] = t < t_end;
      if (ok[i] && live) {
        const size_t off = size_t(__ldg(table + t / page)) * page_stride +
                           size_t(t % page) * tok_stride + lane_off;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kr[i][v] = __ldg(reinterpret_cast<const uint4*>(kp + off + v * EPL));
          vr[i][v] = __ldg(reinterpret_cast<const uint4*>(vp + off + v * EPL));
        }
      } else {
#pragma unroll
        for (int v = 0; v < NV; ++v) kr[i][v] = vr[i][v] = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // Scores of this lane's NL tokens for each head: partial dots, then a
    // sum over the LPW lanes of the token (idle lanes add 0).
    float s[NL][G];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const T* kv = reinterpret_cast<const T*>(&kr[i][v]);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            dot = fmaf(qr[g][v * EPL + e], repro::to_f32(kv[e]), dot);
        }
        s[i][g] = dot;
      }
    }
#pragma unroll
    for (int off = LPW / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);

    float vf[NL][EPT];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T* vv = reinterpret_cast<const T*>(&vr[i][v]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) vf[i][v * EPL + e] = repro::to_f32(vv[e]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (ok[i]) mx = fmax_nan(mx, s[i][g]);
      const float m_new = fmax_nan(m[g], mx);
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
      for (int e = 0; e < EPT; ++e) {
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
  for (int off = LPW; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmax_nan(m[g], m2);
      const float mu = M == -INFINITY ? 0.f : M;
      const float a = exp2f(m[g] - mu);
      const float c = exp2f(m2 - mu);
      l[g] = l[g] * a + l2 * c;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
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
      for (int e = 0; e < EPT; ++e) sm_acc[w][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32) {
    const int g = idx / HD;
    const int d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) M = fmax_nan(M, sm_m[ww][g]);
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
      o[bh * HD + d] = repro::from_f32<T>(L == 0.f ? 0.f : O / L);  // a NaN L passes
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
// 0 where no partial holds a token.  A NaN partial (a NaN in q or in a
// visible row: the split kernels keep its max NaN) makes M NaN, so every
// weight and the output are NaN, as in the plain version; for finite
// partials fmax_nan is fmaxf, so the arithmetic is unchanged.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    paged_merge_kernel(const float* __restrict__ part, T* __restrict__ o, int BH, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part + bh * n_split;
  const float* pl = part + size_t(BH) * n_split + bh * n_split;
  const float* po = part + 2 * size_t(BH) * n_split + bh * n_split * HD;
  float M = -INFINITY;
  for (int i = 0; i < n_split; ++i) M = fmax_nan(M, pm[i]);
  float L = 0.f, O = 0.f;
  for (int i = 0; i < n_split; ++i) {
    if (pm[i] == -INFINITY) continue;  // empty partition
    const float wt = exp2f(pm[i] - M);
    L = fmaf(pl[i], wt, L);
    O = fmaf(po[size_t(i) * HD + d], wt, O);
  }
  o[bh * HD + d] = repro::from_f32<T>(L == 0.f ? 0.f : O / L);
}

// ---------------------------------------------------------------------------
// The tile, ring and M tile of the tensor-core split kernels (grouped bf16
// below, and both MLA kernels).
using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTile = 8 * kMmaWarps;  // tokens a stage holds: one n8 column tile of S a warp
// Depth of the cp.async ring: three and four stages (one block an SM) timed
// no faster than two at the MLA serve's shapes (PERF.md section 6).
constexpr int kStages = 2;
static_assert(kStages >= 2, "the refill of a stage waits for the barrier of the next tile");
constexpr int kM = 16;                // rows of the M tile: the G heads, zero-padded

// Element offset of 16-byte chunk c of row r in a (rows, HD) tile of T whose
// chunks are XOR-swizzled by row (common.cuh::swizzle_chunk, as in
// flash_attention.cu): the 8 rows an ldmatrix reads land in 8 different
// bank groups.
template <int HD, typename T = bf16>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kEl = 16 / sizeof(T);  // elements of a chunk
  return r * HD + repro::swizzle_chunk<HD / kEl>(r, c) * kEl;
}

// ---------------------------------------------------------------------------
// Grouped bf16 decode on the tensor cores: G = H / KH of 2, 4, 8 or 16 query
// heads a KV head, keys and values of HD in pages of their own.
namespace gqa {

// Row of one warp's f32 output in the sum over the warps at the end of the
// walk, padded by 8 words: the float2 stores of a fragment's 8 rows fall in
// 32 different banks.
template <int HD>
constexpr int kLDO = HD + 8;

// Bytes of the ring (kStages stages of a K and a V tile), whose space then
// takes every warp's output rows after the walk.
template <int HD>
constexpr size_t kRingBytes = sizeof(bf16) * size_t(kStages) * 2 * kTile * HD;
template <int HD>
constexpr size_t kSumsBytes = sizeof(float) * size_t(kMmaWarps) * kM * kLDO<HD>;
template <int HD>
constexpr size_t kScratchBytes = kRingBytes<HD> > kSumsBytes<HD> ? kRingBytes<HD> : kSumsBytes<HD>;

template <int HD>
constexpr size_t smem_bytes() {  // Q, the ring (then the sums), the tile max and sums of each warp
  return sizeof(bf16) * size_t(kM) * HD + kScratchBytes<HD> + sizeof(float) * 2 * kMmaWarps * kM;
}

// Start the copy of tile `it` of the partition [t_begin, t_end) into its
// stage: the K rows and the V rows of its TILE tokens, from their pages,
// one 16-byte chunk of each a copy; a row's page is looked up once for both.
// Rows at or past t_end are zero-filled and never read.  T is bf16 or f32;
// NT threads share the copies.
template <int HD, int NT = kMmaThreads, int TILE = kTile, typename T>
__device__ __forceinline__ void stage_kv(T* __restrict__ ring, const T* __restrict__ kbase,
                                         const T* __restrict__ vbase,
                                         const int* __restrict__ table, int page,
                                         size_t page_stride, size_t tok_stride, int t_begin,
                                         int t_end, int it) {
  constexpr int kEl = 16 / sizeof(T);  // elements of a chunk
  constexpr int kChunks = HD / kEl;
  constexpr int kCopies = TILE * kChunks;
  T* kdst = ring + (it % kStages) * 2 * TILE * HD;
  T* vdst = kdst + TILE * HD;
  const int t0 = t_begin + it * TILE;
#pragma unroll
  for (int i = 0; i < (kCopies + NT - 1) / NT; ++i) {
    const int idx = i * NT + threadIdx.x;
    if (kCopies % NT != 0 && idx >= kCopies) break;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int t = t0 + r;
    const bool ok = t < t_end;
    const size_t off =
        ok ? size_t(__ldg(table + t / page)) * page_stride + size_t(t % page) * tok_stride : 0;
    repro::cp_async_16(kdst + swz<HD, T>(r, c), kbase + off + c * kEl, ok);
    repro::cp_async_16(vdst + swz<HD, T>(r, c), vbase + off + c * kEl, ok);
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(kMmaThreads, 2)
    paged_gqa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                         const bf16* __restrict__ vp, const int* __restrict__ block_table,
                         const int* __restrict__ seq_lens, bf16* __restrict__ o,
                         float* __restrict__ part, int H, int KH, int page, int max_pages,
                         int partition, int n_split, float scale_log2) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row = 8-column tiles of O
  constexpr int KS = HD / 16;      // k-steps of Q K^T (5 at hd 80)
  constexpr int DT = kChunks;      // 8-column tiles of the output, each warp all of them
  // Q's A fragments held in registers for the whole walk up to hd 128; at
  // hd 256 they would take 64 registers beside the 128 of the accumulator,
  // so there each k-step reads its fragment from the Q tile (as flash does).
  constexpr bool kHoldQ = HD <= 128;
  static_assert(G >= 2 && G <= kM && HD % 16 == 0 && (DT % 4 == 0 || DT % 4 == 2) &&
                    (kHoldQ || KS % 2 == 0),
                "shape the grouped tensor-core kernel does not tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kM][HD], swizzled
  bf16* ring = Qs + kM * HD;                     // [kStages][K, V][kTile][HD], swizzled
  float* sums = reinterpret_cast<float*>(ring);  // [kMmaWarps][kM][kLDO], once the walk is done
  float* red_m = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring) +
                                          kScratchBytes<HD>);
  float* red_l = red_m + kMmaWarps * kM;  // [kMmaWarps][kM] each

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;  // fragment row: heads grp and grp + 8
  const int quad = lane & 3;  // fragment column pair
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
      for (int idx = tid; idx < G * HD; idx += kMmaThreads)
        o[bh0 * HD + idx] = __float2bfloat16(0.f);
    } else if (tid < G) {
      part_m[(bh0 + tid) * n_split + split] = -INFINITY;
      part_l[(bh0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * HD;
  const size_t page_stride = size_t(page) * tok_stride;
  const bf16* kbase = kp + size_t(kh) * HD;
  const bf16* vbase = vp + size_t(kh) * HD;
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;

  // Q (rows >= G zero) and tile 0 in the first group, tiles 1 .. kStages - 1
  // in one group each, committed even when empty (as in the MLA kernel).
  for (int idx = tid; idx < kM * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = r < G;
    repro::cp_async_16(Qs + swz<HD>(r, c), q + (bh0 + (ok ? r : 0)) * HD + c * 8, ok);
  }
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles)
      stage_kv<HD>(ring, kbase, vbase, table, page, page_stride, tok_stride, t_begin, t_end, i);
    repro::cp_async_commit();
  }

  float acc[DT][4];  // this warp's tokens' share of O: 16 heads x HD
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // heads grp, grp + 8; the same in every warp
  float l_run[2] = {0.f, 0.f};              // this lane's share of this warp's tokens
  uint32_t qf[kHoldQ ? KS : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const bf16* Kt = ring + (it % kStages) * 2 * kTile * HD;
    const bf16* Vt = Kt + kTile * HD;
    if (it == 0)
      repro::cp_async_wait<kStages - 1>();
    else
      repro::cp_async_wait<kStages - 2>();
    // (A) Tile it (and at it = 0, Q) is visible to every thread, and every
    // warp is done with tile it - 1, whose stage tile it - 1 + kStages now
    // fills.
    __syncthreads();
    if (it >= 1) {
      if (it - 1 + kStages < n_tiles)
        stage_kv<HD>(ring, kbase, vbase, table, page, page_stride, tok_stride, t_begin, t_end,
                     it - 1 + kStages);
      repro::cp_async_commit();
    }
    if constexpr (kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          repro::ldmatrix_x4(qf[kk], Qs + swz<HD>(lane & 15, 2 * kk + (lane >> 4)));
      }
    }

    // S = Q K^T for this warp's 8 tokens: 16 heads x 8 tokens; K's B
    // fragments of two k-steps by one ldmatrix, of an odd last one (hd 80)
    // by a half one; four accumulators taken in turn.
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[a][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KS / 2; ++j) {  // k-steps 2j and 2j + 1
      uint32_t kf[4];
      repro::ldmatrix_x4(kf, Kt + swz<HD>(8 * warp + (lane & 7), 4 * j + (lane >> 3)));
      if constexpr (kHoldQ) {
        repro::mma_bf16_16816(s[(2 * j) & 3], qf[2 * j], kf[0], kf[1]);
        repro::mma_bf16_16816(s[(2 * j + 1) & 3], qf[2 * j + 1], kf[2], kf[3]);
      } else {
        uint32_t qa[4], qb[4];
        repro::ldmatrix_x4(qa, Qs + swz<HD>(lane & 15, 4 * j + (lane >> 4)));
        repro::ldmatrix_x4(qb, Qs + swz<HD>(lane & 15, 4 * j + 2 + (lane >> 4)));
        repro::mma_bf16_16816(s[(2 * j) & 3], qa, kf[0], kf[1]);
        repro::mma_bf16_16816(s[(2 * j + 1) & 3], qb, kf[2], kf[3]);
      }
    }
    if constexpr (KS % 2 == 1) {
      uint32_t kf[2];
      repro::ldmatrix_x2(kf, Kt + swz<HD>(8 * warp + (lane & 7), 2 * (KS - 1) + ((lane >> 3) & 1)));
      repro::mma_bf16_16816(s[(KS - 1) & 3], qf[KS - 1], kf[0], kf[1]);
    }
    float sc[4];  // log2-domain scores: heads grp (e = 0, 1), grp + 8 (e = 2, 3)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + 8 * warp + 2 * quad + (e & 1);
      const float v = (s[0][e] + s[1][e]) + (s[2][e] + s[3][e]);
      sc[e] = t < t_end ? v * scale_log2 : -INFINITY;
    }

    // The tile's max of each head: the lane's 2 tokens, the quad, the warps.
    float mx[2] = {fmax_nan(sc[0], sc[1]), fmax_nan(sc[2], sc[3])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (quad == 0) {
      red_m[warp * kM + grp] = mx[0];
      red_m[warp * kM + grp + 8] = mx[1];
    }
    // (B) Every warp's max is written; no warp writes red_m again before
    // the next tile's barrier (A), by which every warp has read it.
    __syncthreads();
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = red_m[grp + 8 * r];
#pragma unroll
      for (int w = 1; w < kMmaWarps; ++w) m = fmax_nan(m, red_m[w * kM + grp + 8 * r]);
      // finite inputs: finite, the tile's first token is visible; a NaN
      // score keeps the head's max NaN, so the merge sees a NaN partial
      mu[r] = fmax_nan(m_run[r], m);
      const float corr = exp2f(m_run[r] - mu[r]);
      m_run[r] = mu[r];
      l_run[r] *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }
    const float p0 = exp2f(sc[0] - mu[0]);
    const float p1 = exp2f(sc[1] - mu[0]);
    const float p2 = exp2f(sc[2] - mu[1]);
    const float p3 = exp2f(sc[3] - mu[1]);
    l_run[0] += p0 + p1;
    l_run[1] += p2 + p3;

    // O += P V over this warp's 8 tokens, all HD columns: the scores'
    // accumulator layout is the A fragment of m16n8k8, so P (rounded to
    // bf16) stays in registers; V's B fragments are ldmatrix.trans of the
    // staged rows, four column tiles a load (two for the last two at hd 80).
    const uint32_t pa[2] = {repro::pack_bf16x2(p0, p1), repro::pack_bf16x2(p2, p3)};
#pragma unroll
    for (int j = 0; j < DT / 4; ++j) {
      uint32_t vf[4];
      repro::ldmatrix_x4_trans(vf, Vt + swz<HD>(8 * warp + (lane & 7), 4 * j + (lane >> 3)));
#pragma unroll
      for (int i = 0; i < 4; ++i) repro::mma_bf16_1688(acc[4 * j + i], pa, vf[i]);
    }
    if constexpr (DT % 4 == 2) {
      uint32_t vf[2];
      repro::ldmatrix_x2_trans(vf, Vt + swz<HD>(8 * warp + (lane & 7), DT - 2 + ((lane >> 3) & 1)));
      repro::mma_bf16_1688(acc[DT - 2], pa, vf[0]);
      repro::mma_bf16_1688(acc[DT - 1], pa, vf[1]);
    }
  }

  // Sum the warps' outputs and sums (every warp took the same max): the
  // ring's copies have all landed (the groups after the last tile are
  // empty) and every warp is done with the last tile, so it takes the sums.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = sums + (warp * kM + grp + 8 * r) * kLDO<HD> + 2 * quad;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(row + 8 * d) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
  if (quad == 0) {
    red_l[warp * kM + grp] = l_run[0];
    red_l[warp * kM + grp + 8] = l_run[1];
  }
  if (n_split > 1 && warp == 0 && quad == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (grp + 8 * r < G) part_m[(bh0 + grp + 8 * r) * n_split + split] = m_run[r];
  }
  __syncthreads();
  // Rows >= G are zero rows of the M tile and never written back.
  for (int idx = tid; idx < G * (HD / 4); idx += kMmaThreads) {
    const int g = idx / (HD / 4);
    const int c = idx % (HD / 4) * 4;
    float4 O = *reinterpret_cast<const float4*>(sums + g * kLDO<HD> + c);
    float L = red_l[g];
#pragma unroll
    for (int w = 1; w < kMmaWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(sums + (w * kM + g) * kLDO<HD> + c);
      O = make_float4(O.x + x.x, O.y + x.y, O.z + x.z, O.w + x.w);
      L += red_l[w * kM + g];
    }
    const size_t bh = bh0 + g;
    if (n_split == 1) {
      const float inv = L == 0.f ? 0.f : 1.f / L;  // a NaN L passes
      *reinterpret_cast<uint2*>(o + bh * HD + c) =
          make_uint2(repro::pack_bf16x2(O.x * inv, O.y * inv),
                     repro::pack_bf16x2(O.z * inv, O.w * inv));
    } else {
      *reinterpret_cast<float4*>(part_o + (bh * n_split + split) * HD + c) = O;
      if (c == 0) part_l[bh * n_split + split] = L;
    }
  }
}

template <int HD, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt, const void* sl,
                   void* o, void* part, int B, int H, int KH, int page, int max_pages,
                   int partition, int n_split, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = paged_gqa_mma_kernel<HD, G>;
  // Set once per instance, as for the MLA kernels: the shared memory above
  // 48 KB (at hd 256), and the largest carveout.
  static const cudaError_t attr_err = [kern] {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  cudaError_t err = attr_err;
  if (err != cudaSuccess) return err;
  const dim3 grid(KH, B, n_split);  // one block a KV head's group
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<bf16*>(o),
      static_cast<float*>(part), H, KH, page, max_pages, partition, n_split,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<bf16, HD><<<B * H, HD, 0, stream>>>(static_cast<const float*>(part),
                                                        static_cast<bf16*>(o), B * H, n_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 twin: three TF32 products a multiply, 8 warps a block.
constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;

// Tokens a tile: 32, as in the bf16 kernel, but 16 at hd 256, where a
// 32-token ring (128 KB) leaves room for one block an SM.  On an NVIDIA
// H100 80GB HBM3 at 700 W (graph timer, PERF.md section 6), gemma3-4b's 8
// rings of 1024 at 4 KV heads (256 blocks) took 0.0382 ms at 32 and 0.0310
// at 16, one long slot among short ones 0.0235 and 0.0298: each wins a
// case, and 16 wins gemma3's serve, 29 ring layers of 34.
template <int HD>
constexpr int kF32Tile = HD > 128 ? 16 : kTile;

template <int HD>
constexpr size_t tf32x3_smem_bytes() {  // Q's big and small planes, the ring (then the sums),
                                        // each warp's partial scores, each group's sums
  return sizeof(float) * (2 * size_t(kM) * HD + size_t(kStages) * 2 * kF32Tile<HD> * HD +
                          4 * kF32Warps * 32 + kF32Tile<HD> / 8 * kM);
}

template <int HD, int G>
__global__ void __launch_bounds__(kF32Threads, 2)  // two blocks an SM: 128 registers a thread
    paged_gqa_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                            const float* __restrict__ vp, const int* __restrict__ block_table,
                            const int* __restrict__ seq_lens, float* __restrict__ o,
                            float* __restrict__ part, int H, int KH, int page, int max_pages,
                            int partition, int n_split, float scale_log2) {
  constexpr int TILE = kF32Tile<HD>;
  constexpr int NG = TILE / 8;           // 8-token groups of a tile: one n8 tile of S each
  constexpr int NS = kF32Warps / NG;     // warps a group, each a slice of S's k-steps and of O
  constexpr int kChunks = HD / 4;        // 16-byte chunks of a row
  constexpr int KSW = HD / 8 / NS;       // k-steps of Q K^T a warp takes (5 at hd 80)
  constexpr int DTW = HD / 8 / NS;       // 8-column tiles of the output a warp takes
  constexpr int kQChunks = kM * kChunks;
  constexpr int kQPerThread = (kQChunks + kF32Threads - 1) / kF32Threads;
  // Q's split A fragments (8 registers a k-step) held in registers over the
  // walk at hd 64 (32 of them); wider rows read them from the planes.
  constexpr bool kHoldQ = HD <= 64;
  constexpr int kDG = DTW % 4 == 0 ? 4 : DTW;  // output tiles a group of V loads: 5 at hd 80
  static_assert(G >= 2 && G <= kM && HD % 16 == 0 && NG * NS == kF32Warps &&
                    HD / 8 % NS == 0 && DTW % kDG == 0 && 16 * TILE * HD >= 8 * TILE * (HD + 8),
                "shape the grouped 3xTF32 kernel does not tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qb = reinterpret_cast<float*>(smem_raw);  // [kM][HD] TF32 big parts, swizzled
  float* Qsm = Qb + kM * HD;                       // [kM][HD] small parts
  float* ring = Qsm + kM * HD;                     // [kStages][K, V][TILE][HD], swizzled
  float* sums = ring;                              // [NG][kM][kLDO], once the walk is done
  float4* Sp = reinterpret_cast<float4*>(ring + kStages * 2 * TILE * HD);  // [kF32Warps][32]
  float* red_l = reinterpret_cast<float*>(Sp + kF32Warps * 32);            // [NG][kM]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tg = warp % NG;     // this warp's tokens: 8 tg .. 8 tg + 7 of each tile
  const int slice = warp / NG;  // and its slice of S's k-steps and of the output columns
  const int grp = lane >> 2;  // fragment row: heads grp and grp + 8
  const int quad = lane & 3;  // fragment column
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int B = gridDim.y;
  const int t_begin = split * partition;
  const size_t bh0 = size_t(b) * H + size_t(kh) * G;

  // Q's loads need no seq_len, so they go out before it is read: this
  // thread's chunks of the 16 x HD tile, rows >= G zero.
  float4 qv[kQPerThread];
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    const int idx = i * kF32Threads + tid;
    const int r = idx / kChunks;
    qv[i] = idx < kQChunks && r < G
                ? __ldg(reinterpret_cast<const float4*>(q + (bh0 + r) * HD) + idx % kChunks)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int t_end = min(seq_lens[b], t_begin + partition);
  float* part_m = part;
  float* part_l = part + size_t(B) * H * n_split;
  float* part_o = part + 2 * size_t(B) * H * n_split;
  if (t_begin >= t_end) {  // nothing of this sequence in the partition
    if (n_split == 1) {
      for (int idx = tid; idx < G * HD; idx += kF32Threads) o[bh0 * HD + idx] = 0.f;
    } else if (tid < G) {
      part_m[(bh0 + tid) * n_split + split] = -INFINITY;
      part_l[(bh0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * HD;
  const size_t page_stride = size_t(page) * tok_stride;
  const float* kbase = kp + size_t(kh) * HD;
  const float* vbase = vp + size_t(kh) * HD;
  const int n_tiles = (t_end - t_begin + TILE - 1) / TILE;

  // Every stage is in flight before the first product, each tile a group
  // of its own, committed even when empty (as in the bf16 kernel).
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles)
      stage_kv<HD, kF32Threads, TILE>(ring, kbase, vbase, table, page, page_stride, tok_stride,
                                      t_begin, t_end, i);
    repro::cp_async_commit();
  }
  // Q split once into its big and small planes while the copies fly; the
  // first tile's barrier makes them visible.
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    const int idx = i * kF32Threads + tid;
    if (kQChunks % kF32Threads != 0 && idx >= kQChunks) break;
    const int at = swz<HD, float>(idx / kChunks, idx % kChunks);
    uint32_t big[4], sml[4];
    const uint32_t x[4] = {__float_as_uint(qv[i].x), __float_as_uint(qv[i].y),
                           __float_as_uint(qv[i].z), __float_as_uint(qv[i].w)};
    repro::split_x4(x, big, sml);
    *reinterpret_cast<uint4*>(Qb + at) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(Qsm + at) = make_uint4(sml[0], sml[1], sml[2], sml[3]);
  }

  float acc[DTW][4];  // this warp's tokens' share of O: 16 heads x its 8 * DTW columns
#pragma unroll
  for (int d = 0; d < DTW; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // heads grp, grp + 8; the same in every warp
  float l_run[2] = {0.f, 0.f};              // this lane's share of this group's tokens
  uint32_t qbig[kHoldQ ? KSW : 1][4], qsml[kHoldQ ? KSW : 1][4];
  const int ks0 = slice * KSW;  // this warp's first k-step of Q K^T
  const int dt0 = slice * DTW;  // and first 8-column tile of O

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * TILE;
    const float* Kt = ring + (it % kStages) * 2 * TILE * HD;
    const float* Vt = Kt + TILE * HD;
    if (it == 0)
      repro::cp_async_wait<kStages - 1>();
    else
      repro::cp_async_wait<kStages - 2>();
    // (A) Tile it (and at it = 0, Q's planes) is visible to every thread,
    // and every warp is done with tile it - 1, whose stage tile
    // it - 1 + kStages now fills, and with its partial scores.
    __syncthreads();
    if (it >= 1) {
      if (it - 1 + kStages < n_tiles)
        stage_kv<HD, kF32Threads, TILE>(ring, kbase, vbase, table, page, page_stride,
                                        tok_stride, t_begin, t_end, it - 1 + kStages);
      repro::cp_async_commit();
    }
    if constexpr (kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSW; ++kk) {
          const int at = swz<HD, float>(lane & 15, 2 * (ks0 + kk) + (lane >> 4));
          repro::ldmatrix_x4(qbig[kk], Qb + at);
          repro::ldmatrix_x4(qsml[kk], Qsm + at);
        }
      }
    }

    // This warp's slice of S = Q K^T for its group's 8 tokens: 16 heads x 8
    // tokens over k-steps ks0 .. ks0 + KSW - 1.  K's B fragments of two
    // k-steps come by one ldmatrix (b16) from the row-major f32 tile (an
    // 8x8 b16 matrix is 8 rows of 4 words), of an odd last one (hd 80) by a
    // half one, and are split as loaded; Q's split A fragments come from
    // the planes (or registers).  Big * big and the cross terms go to
    // accumulators of their own, two of each taken in turn.
    float s_hi[2][4], s_lo[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_hi[a][e] = s_lo[a][e] = 0.f;
    const auto qfrag = [&](int kk, uint32_t (&qb)[4], uint32_t (&qs)[4]) {
      if constexpr (kHoldQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qb[i] = qbig[kk][i];
          qs[i] = qsml[kk][i];
        }
      } else {
        const int at = swz<HD, float>(lane & 15, 2 * (ks0 + kk) + (lane >> 4));
        repro::ldmatrix_x4(qb, Qb + at);
        repro::ldmatrix_x4(qs, Qsm + at);
      }
    };
#pragma unroll
    for (int j = 0; j < KSW / 2; ++j) {  // this warp's k-steps 2j and 2j + 1
      uint32_t kf[4], kb[4], ks[4];
      repro::ldmatrix_x4(kf, Kt + swz<HD, float>(8 * tg + (lane & 7),
                                                 2 * (ks0 + 2 * j) + (lane >> 3)));
      repro::split_x4(kf, kb, ks);
      uint32_t qb0[4], qs0[4], qb1[4], qs1[4];
      qfrag(2 * j, qb0, qs0);
      qfrag(2 * j + 1, qb1, qs1);
      repro::mma_tf32_1688(s_lo[0], qs0, kb[0], kb[1]);
      repro::mma_tf32_1688(s_lo[1], qs1, kb[2], kb[3]);
      repro::mma_tf32_1688(s_hi[0], qb0, kb[0], kb[1]);
      repro::mma_tf32_1688(s_hi[1], qb1, kb[2], kb[3]);
      repro::mma_tf32_1688(s_lo[0], qb0, ks[0], ks[1]);
      repro::mma_tf32_1688(s_lo[1], qb1, ks[2], ks[3]);
    }
    if constexpr (KSW % 2 == 1) {
      uint32_t kf[2], kb[2], ks[2];
      repro::ldmatrix_x2(kf, Kt + swz<HD, float>(8 * tg + (lane & 7),
                                                 2 * (ks0 + KSW - 1) + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < 2; ++i) repro::split_tf32(__uint_as_float(kf[i]), kb[i], ks[i]);
      uint32_t qb0[4], qs0[4];
      qfrag(KSW - 1, qb0, qs0);
      repro::mma_tf32_1688(s_lo[0], qs0, kb[0], kb[1]);
      repro::mma_tf32_1688(s_hi[0], qb0, kb[0], kb[1]);
      repro::mma_tf32_1688(s_lo[0], qb0, ks[0], ks[1]);
    }
    Sp[warp * 32 + lane] =
        make_float4((s_hi[0][0] + s_hi[1][0]) + (s_lo[0][0] + s_lo[1][0]),
                    (s_hi[0][1] + s_hi[1][1]) + (s_lo[0][1] + s_lo[1][1]),
                    (s_hi[0][2] + s_hi[1][2]) + (s_lo[0][2] + s_lo[1][2]),
                    (s_hi[0][3] + s_hi[1][3]) + (s_lo[0][3] + s_lo[1][3]));
    // (B) Every warp's partial scores are written; no warp writes them again
    // before the next tile's barrier (A), by which every warp has read them.
    __syncthreads();

    // Every warp sums the slices of every group's scores, in the same
    // order, so each takes the tile's max of each head itself.
    float sc[NG][4];  // log2-domain scores: heads grp (e = 0, 1), grp + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      float4 x = Sp[n * 32 + lane];
#pragma unroll
      for (int sl = 1; sl < NS; ++sl) {
        const float4 y = Sp[(sl * NG + n) * 32 + lane];
        x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      }
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * n + 2 * quad + (e & 1);
        sc[n][e] = t < t_end ? v[e] * scale_log2 : -INFINITY;
      }
      mx[0] = fmax_nan(mx[0], fmax_nan(sc[n][0], sc[n][1]));
      mx[1] = fmax_nan(mx[1], fmax_nan(sc[n][2], sc[n][3]));
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mu[r] = fmax_nan(m_run[r], mx[r]);  // finite inputs: finite, the tile's first token is seen
      const float corr = repro::ex2_approx(m_run[r] - mu[r]);
      m_run[r] = mu[r];
      l_run[r] *= corr;
#pragma unroll
      for (int d = 0; d < DTW; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // select this warp's group by a loop, so sc stays in registers
      float s = sc[0][e];
#pragma unroll
      for (int n = 1; n < NG; ++n) s = tg == n ? sc[n][e] : s;
      p[e] = repro::ex2_approx(s - mu[e >> 1]);
    }
    l_run[0] += p[0] + p[1];
    l_run[1] += p[2] + p[3];

    // O += P V over this group's 8 tokens and this warp's slice of the
    // columns, one m16n8k8 k-step.  P's A fragment takes this lane's tokens
    // 2 quad and 2 quad + 1 as its columns quad and quad + 4 (the sum over
    // tokens takes any order), so it comes from the scores' accumulator
    // layout with no shuffle, and V's B fragment b0 = V[8 tg + 2 quad][col],
    // b1 = V[8 tg + 2 quad + 1][col] (col = 8 d + grp): scalar loads of the
    // staged rows (ldmatrix.trans would cut each word in two), split as
    // loaded, kDG output tiles at a time.
    const uint32_t pf[4] = {__float_as_uint(p[0]), __float_as_uint(p[2]), __float_as_uint(p[1]),
                            __float_as_uint(p[3])};
    uint32_t pbig[4], psml[4];
    repro::split_x4(pf, pbig, psml);
    const int vr = 8 * tg + 2 * quad;
#pragma unroll
    for (int d0 = 0; d0 < DTW; d0 += kDG) {
      uint32_t vbig[kDG][2], vsml[kDG][2];
#pragma unroll
      for (int g = 0; g < kDG; ++g) {
        const int col = 8 * (dt0 + d0 + g) + grp;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          repro::split_tf32(Vt[swz<HD, float>(vr + r, col >> 2) + (col & 3)], vbig[g][r],
                            vsml[g][r]);
      }
#pragma unroll
      for (int g = 0; g < kDG; ++g) repro::mma_tf32_1688(acc[d0 + g], psml, vbig[g][0], vbig[g][1]);
#pragma unroll
      for (int g = 0; g < kDG; ++g) repro::mma_tf32_1688(acc[d0 + g], pbig, vsml[g][0], vsml[g][1]);
#pragma unroll
      for (int g = 0; g < kDG; ++g) repro::mma_tf32_1688(acc[d0 + g], pbig, vbig[g][0], vbig[g][1]);
    }
  }

  // Sum the groups' outputs and sums (every warp took the same max): the
  // ring's copies have all landed and every warp is done with the last
  // tile, so its space takes each group's rows, each warp its slice.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = sums + (tg * kM + grp + 8 * r) * kLDO<HD> + 8 * dt0 + 2 * quad;
#pragma unroll
    for (int d = 0; d < DTW; ++d)
      *reinterpret_cast<float2*>(row + 8 * d) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
  if (slice == 0 && quad == 0) {  // every slice of a group holds the same sums
    red_l[tg * kM + grp] = l_run[0];
    red_l[tg * kM + grp + 8] = l_run[1];
  }
  if (n_split > 1 && warp == 0 && quad == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (grp + 8 * r < G) part_m[(bh0 + grp + 8 * r) * n_split + split] = m_run[r];
  }
  __syncthreads();
  // Rows >= G are zero rows of the M tile and never written back.
  for (int idx = tid; idx < G * (HD / 4); idx += kF32Threads) {
    const int g = idx / (HD / 4);
    const int c = idx % (HD / 4) * 4;
    float4 O = *reinterpret_cast<const float4*>(sums + g * kLDO<HD> + c);
    float L = red_l[g];
#pragma unroll
    for (int n = 1; n < NG; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(sums + (n * kM + g) * kLDO<HD> + c);
      O = make_float4(O.x + x.x, O.y + x.y, O.z + x.z, O.w + x.w);
      L += red_l[n * kM + g];
    }
    const size_t bh = bh0 + g;
    if (n_split == 1) {
      const float inv = L == 0.f ? 0.f : 1.f / L;  // a NaN L passes
      *reinterpret_cast<float4*>(o + bh * HD + c) =
          make_float4(O.x * inv, O.y * inv, O.z * inv, O.w * inv);
    } else {
      *reinterpret_cast<float4*>(part_o + (bh * n_split + split) * HD + c) = O;
      if (c == 0) part_l[bh * n_split + split] = L;
    }
  }
}

template <int HD, int G>
cudaError_t launch_tf32x3(const void* q, const void* kp, const void* vp, const void* bt,
                          const void* sl, void* o, void* part, int B, int H, int KH, int page,
                          int max_pages, int partition, int n_split, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = tf32x3_smem_bytes<HD>();
  static_assert(2 * smem <= 227 * 1024, "two blocks an SM, as the launch bounds assume");
  auto kern = paged_gqa_tf32x3_kernel<HD, G>;
  // Set once per instance, as for the bf16 kernel: the shared memory above
  // 48 KB (from hd 80), and the largest carveout.
  static const cudaError_t attr_err = [kern] {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  cudaError_t err = attr_err;
  if (err != cudaSuccess) return err;
  const dim3 grid(KH, B, n_split);  // one block a KV head's group
  kern<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp), static_cast<const float*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<float*>(o),
      static_cast<float*>(part), H, KH, page, max_pages, partition, n_split,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<float, HD><<<B * H, HD, 0, stream>>>(static_cast<const float*>(part),
                                                         static_cast<float*>(o), B * H, n_split);
  return cudaGetLastError();
}

// bf16 runs the bf16 tensor-core kernel, f32 the 3xTF32 one.
template <typename T, int HD, int G>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const void* bt,
                         const void* sl, void* o, void* part, int B, int H, int KH, int page,
                         int max_pages, int partition, int n_split, float scale,
                         cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch<HD, G>(q, kp, vp, bt, sl, o, part, B, H, KH, page, max_pages, partition,
                         n_split, scale, st);
  else
    return launch_tf32x3<HD, G>(q, kp, vp, bt, sl, o, part, B, H, KH, page, max_pages,
                                partition, n_split, scale, st);
}

}  // namespace gqa

// One query head a KV head (G = 1, so H = KH): the split kernel, then the
// merge where there is more than one partition.
template <typename T, int HD>
cudaError_t launch_split(const void* q, const void* kp, const void* vp, const void* bt,
                         const void* sl, void* o, void* part, int B, int H, int page,
                         int max_pages, int partition, int n_split, float scale,
                         cudaStream_t stream) {
  const dim3 grid(H, B, n_split);  // one block a head
  paged_split_kernel<T, HD, 1><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(o),
      static_cast<float*>(part), H, H, page, max_pages, partition, n_split,
      scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<T, HD><<<B * H, HD, 0, stream>>>(static_cast<const float*>(part),
                                                     static_cast<T*>(o), B * H, n_split);
  return cudaGetLastError();
}

// One query head a KV head (llama2's MHA) runs `paged_split_kernel` in both
// types; groups of 2 to 16 run the tensor-core kernels: bf16
// `paged_gqa_mma_kernel`, f32 `paged_gqa_tf32x3_kernel` (G = 16, e.g.
// recurrentgemma-9b's MQA, one M tile in both).
template <typename T, int HD>
cudaError_t launch_group(int G, const void* q, const void* kp, const void* vp, const void* bt,
                         const void* sl, void* o, void* part, int B, int H, int KH, int page,
                         int max_pages, int partition, int n_split, float scale,
                         cudaStream_t st) {
#define REPRO_GQA_CASE(GG)                                                                 \
  case GG:                                                                                 \
    return gqa::launch_typed<T, HD, GG>(q, kp, vp, bt, sl, o, part, B, H, KH, page,        \
                                        max_pages, partition, n_split, scale, st);
  switch (G) {
    case 1:
      return launch_split<T, HD>(q, kp, vp, bt, sl, o, part, B, H, page, max_pages, partition,
                                 n_split, scale, st);
    REPRO_GQA_CASE(2)
    REPRO_GQA_CASE(4)
    REPRO_GQA_CASE(8)
    REPRO_GQA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_GQA_CASE
}


// ---------------------------------------------------------------------------
// MLA: keys of DK, values the first DV columns of the same rows, G heads.
namespace mla {

// Query-head tiles of a group of G heads: the M tile holds kM heads, so a
// larger group (minicpm3-4b: G = 40) takes ceil(G / kM) blocks, each
// staging its tile's heads (16, 16 and 8 live rows at G = 40); the
// latent rows are read once a tile, mostly from L2.
template <int G>
constexpr int kHeadTiles = (G + kM - 1) / kM;

// Start the copy of tile `it` of the partition [t_begin, t_end) into its
// stage: with TPR = NT / kTile threads a row, thread i copies every TPR-th
// 16-byte chunk of row i / TPR (token t), whose page `pg` it has looked up;
// rows at or past t_end are zero-filled.
template <int DK, int NT, typename T>
__device__ __forceinline__ void stage_rows_at(T* __restrict__ ring, const T* __restrict__ kbase,
                                              int pg, int page, size_t page_stride,
                                              size_t tok_stride, int t_begin, int t_end, int it) {
  constexpr int kEl = 16 / sizeof(T);  // elements of a chunk
  constexpr int kChunks = DK / kEl;
  constexpr int TPR = NT / kTile;
  static_assert(kTile * TPR == NT && kChunks % TPR == 0, "whole rows, whole chunks");
  T* dst = ring + (it % kStages) * kTile * DK;
  const int r = threadIdx.x / TPR;
  const int t = t_begin + it * kTile + r;
  const bool ok = t < t_end;
  const T* src = ok ? kbase + size_t(pg) * page_stride + size_t(t % page) * tok_stride : kbase;
#pragma unroll
  for (int j = 0; j < kChunks / TPR; ++j) {
    const int c = threadIdx.x % TPR + TPR * j;
    repro::cp_async_16(dst + swz<DK, T>(r, c), src + c * kEl, ok);
  }
}

// stage_rows_at, the row's page looked up in the sequence's table row (so a
// row's page is looked up once).
template <int DK, int NT = kMmaThreads, typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ ring, const T* __restrict__ kbase,
                                           const int* __restrict__ table, int page,
                                           size_t page_stride, size_t tok_stride, int t_begin,
                                           int t_end, int it) {
  const int t = t_begin + it * kTile + threadIdx.x / (NT / kTile);
  const int pg = t < t_end ? __ldg(table + t / page) : 0;
  stage_rows_at<DK, NT>(ring, kbase, pg, page, page_stride, tok_stride, t_begin, t_end, it);
}

// ---------------------------------------------------------------------------
// MLA in bf16: tensor cores.
constexpr int kLDP = kTile + 8;       // P's row in bf16, padded to 80 B: ldmatrix conflict-free

template <int DK>
constexpr size_t mma_smem_bytes() {  // Q, the ring, P, the tile max and sums of each warp
  return sizeof(bf16) * (size_t(kM) * DK + size_t(kStages) * kTile * DK + size_t(kM) * kLDP) +
         sizeof(float) * 2 * kMmaWarps * kM;
}


template <int DK, int DV, int G>
__global__ void __launch_bounds__(kMmaThreads, 2)
    paged_mla_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                         const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                         bf16* __restrict__ o, float* __restrict__ part, int H, int KH, int page,
                         int max_pages, int partition, int n_split, float scale_log2) {
  constexpr int kChunks = DK / 8;        // 16-byte chunks of a row
  constexpr int KS = DK / 16;            // k-steps of Q K^T
  constexpr int DW = DV / kMmaWarps;     // output columns of one warp
  constexpr int DT = DW / 8;             // their 8-column tiles
  static_assert(KS % 2 == 0 && kChunks % 4 == 0 && DT % 2 == 0 && DV <= DK,
                "shape the MLA tensor-core kernel does not tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);          // [kM][DK], swizzled
  bf16* ring = Qs + kM * DK;                             // [kStages][kTile][DK], swizzled
  bf16* Ps = ring + kStages * kTile * DK;                // [kM][kLDP]
  float* red_m = reinterpret_cast<float*>(Ps + kM * kLDP);  // [kMmaWarps][kM]
  float* red_l = red_m + kMmaWarps * kM;                 // [kMmaWarps][kM]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;  // fragment row: heads grp and grp + 8
  const int quad = lane & 3;  // fragment column pair
  const int kh = blockIdx.x / kHeadTiles<G>;
  const int g0 = blockIdx.x % kHeadTiles<G> * kM;  // this block's first head of the group
  const int GL = min(kM, G - g0);                     // and its live rows of the M tile
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int B = gridDim.y;
  const int seq_len = seq_lens[b];
  const int t_begin = split * partition;
  const int t_end = min(seq_len, t_begin + partition);
  const size_t bh0 = size_t(b) * H + size_t(kh) * G + g0;
  float* part_m = part;
  float* part_l = part + size_t(B) * H * n_split;
  float* part_o = part + 2 * size_t(B) * H * n_split;

  if (t_begin >= t_end) {  // nothing of this sequence in the partition
    if (n_split == 1) {
      for (int idx = tid; idx < GL * DV; idx += kMmaThreads)
        o[bh0 * DV + idx] = __float2bfloat16(0.f);
    } else if (tid < GL) {
      part_m[(bh0 + tid) * n_split + split] = -INFINITY;
      part_l[(bh0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  const int* table = block_table + size_t(b) * max_pages;
  const size_t tok_stride = size_t(KH) * DK;
  const size_t page_stride = size_t(page) * tok_stride;
  const bf16* kbase = kp + size_t(kh) * DK;
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;

  // Q (rows >= GL zero) and tile 0 in the first group, tiles 1 .. kStages - 1
  // in one group each: every stage is in flight before the first product.
  // A group is committed even when empty, so that the group of tile i is
  // always followed by kStages - 1 others at i = 0 and kStages - 2 later.
  for (int idx = tid; idx < kM * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = r < GL;
    repro::cp_async_16(Qs + swz<DK>(r, c), q + (bh0 + (ok ? r : 0)) * DK + c * 8, ok);
  }
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles)
      stage_rows<DK>(ring, kbase, table, page, page_stride, tok_stride, t_begin, t_end, i);
    repro::cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // heads grp, grp + 8; the same in every warp
  float l_run[2] = {0.f, 0.f};              // this lane's share of this warp's tokens

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const bf16* Kt = ring + (it % kStages) * kTile * DK;
    // Tile it has landed (the groups after its own may still be in flight).
    if (it == 0)
      repro::cp_async_wait<kStages - 1>();
    else
      repro::cp_async_wait<kStages - 2>();
    // (A) Every thread's copies of tile it are visible, and every warp is
    // done with tile it - 1, whose stage tile it - 1 + kStages now fills.
    __syncthreads();
    if (it >= 1) {
      if (it - 1 + kStages < n_tiles)
        stage_rows<DK>(ring, kbase, table, page, page_stride, tok_stride, t_begin, t_end,
                       it - 1 + kStages);
      repro::cp_async_commit();
    }

    // S = Q K^T for this warp's 8 tokens: 16 heads x 8 tokens.
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[a][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KS / 2; ++j) {  // k-steps 2j and 2j + 1
      uint32_t kf[4], qa[4], qb[4];
      repro::ldmatrix_x4(kf, Kt + swz<DK>(8 * warp + (lane & 7), 4 * j + (lane >> 3)));
      repro::ldmatrix_x4(qa, Qs + swz<DK>(lane & 15, 4 * j + (lane >> 4)));
      repro::ldmatrix_x4(qb, Qs + swz<DK>(lane & 15, 4 * j + 2 + (lane >> 4)));
      repro::mma_bf16_16816(s[(2 * j) & 3], qa, kf[0], kf[1]);
      repro::mma_bf16_16816(s[(2 * j + 1) & 3], qb, kf[2], kf[3]);
    }
    float sc[4];  // log2-domain scores: heads grp (e = 0, 1), grp + 8 (e = 2, 3)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + 8 * warp + 2 * quad + (e & 1);
      const float v = (s[0][e] + s[1][e]) + (s[2][e] + s[3][e]);
      sc[e] = t < t_end ? v * scale_log2 : -INFINITY;
    }

    // The tile's max of each head: the lane's 2 tokens, the quad, the warps.
    float mx[2] = {fmax_nan(sc[0], sc[1]), fmax_nan(sc[2], sc[3])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (quad == 0) {
      red_m[warp * kM + grp] = mx[0];
      red_m[warp * kM + grp + 8] = mx[1];
    }
    __syncthreads();  // (B)
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = red_m[grp + 8 * r];
#pragma unroll
      for (int w = 1; w < kMmaWarps; ++w) m = fmax_nan(m, red_m[w * kM + grp + 8 * r]);
      // finite inputs: finite, the tile's first token is visible; a NaN
      // score keeps the head's max NaN, so the merge sees a NaN partial
      mu[r] = fmax_nan(m_run[r], m);
      const float corr = exp2f(m_run[r] - mu[r]);
      m_run[r] = mu[r];
      l_run[r] *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }
    const float p0 = exp2f(sc[0] - mu[0]);
    const float p1 = exp2f(sc[1] - mu[0]);
    const float p2 = exp2f(sc[2] - mu[1]);
    const float p3 = exp2f(sc[3] - mu[1]);
    l_run[0] += p0 + p1;
    l_run[1] += p2 + p3;
    *reinterpret_cast<uint32_t*>(Ps + grp * kLDP + 8 * warp + 2 * quad) =
        repro::pack_bf16x2(p0, p1);
    *reinterpret_cast<uint32_t*>(Ps + (grp + 8) * kLDP + 8 * warp + 2 * quad) =
        repro::pack_bf16x2(p2, p3);
    __syncthreads();  // (C)

    // O += P V over the tile's tokens, this warp's output columns.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      repro::ldmatrix_x4(pa, Ps + (lane & 15) * kLDP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];  // B fragments of column tiles 2 dp and 2 dp + 1
        repro::ldmatrix_x4_trans(
            vf, Kt + swz<DK>(kk * 16 + (lane & 15), warp * (DW / 8) + 2 * dp + (lane >> 4)));
        repro::mma_bf16_16816(acc[2 * dp], pa, vf[0], vf[1]);
        repro::mma_bf16_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // Each head's sum: the quad, then the warps.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (quad == 0) {
    red_l[warp * kM + grp] = l_run[0];
    red_l[warp * kM + grp + 8] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = grp + 8 * r;
    if (g >= GL) continue;  // a zero row of the M tile
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) L += red_l[w * kM + g];
    const size_t bh = bh0 + g;
    const int col = warp * DW + 2 * quad;
    if (n_split == 1) {
      const float inv = L == 0.f ? 0.f : 1.f / L;  // a NaN L passes
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(o + bh * DV + col + 8 * d) =
            repro::pack_bf16x2(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
    } else {
      float* prow = part_o + (bh * n_split + split) * DV + col;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(prow + 8 * d) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
      if (warp == 0 && quad == 0) {
        part_m[bh * n_split + split] = m_run[r];
        part_l[bh * n_split + split] = L;
      }
    }
  }
}

template <int DK, int DV, int G>
cudaError_t launch_mma(const void* q, const void* kp, const void* bt, const void* sl, void* o,
                       void* part, int B, int H, int KH, int page, int max_pages, int partition,
                       int n_split, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DK>();
  auto kern = paged_mla_mma_kernel<DK, DV, G>;
  // Set once per instance (a process drives one card), not on every decode
  // step: the shared memory above 48 KB, and the largest carveout, so that
  // two blocks fit an SM.
  static const cudaError_t attr_err = [kern] {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  cudaError_t err = attr_err;
  if (err != cudaSuccess) return err;
  const dim3 grid(KH * kHeadTiles<G>, B, n_split);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const int*>(bt),
      static_cast<const int*>(sl), static_cast<bf16*>(o), static_cast<float*>(part), H, KH, page,
      max_pages, partition, n_split, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<bf16, DV><<<B * H, DV, 0, stream>>>(static_cast<const float*>(part),
                                                        static_cast<bf16*>(o), B * H, n_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// MLA in f32: three TF32 products on the tensor cores.
constexpr int kF32KW = 9;       // k-steps of Q K^T a warp takes: 72 of the key dims
constexpr int kNT = kTile / 8;  // 8-token column tiles of S = k-steps of P V

// Warps of a block, each a slice of the key dims for S and of the output
// for P V: 8 at dk 576, 4 at dk 288.
template <int DK>
constexpr int kF32WarpsOf = DK / (8 * kF32KW);

template <int DK>
constexpr size_t tf32x3_smem_bytes() {  // the ring, the partial and the summed scores
  return sizeof(float) * size_t(kStages) * kTile * DK +
         sizeof(float4) * (kF32WarpsOf<DK> + 1) * kNT * 32;
}

// The partial scores a thread sums across the warps, as one vector: 2
// floats at 8 warps, 4 at 4.
template <int N>
struct ScoreVec;
template <>
struct ScoreVec<2> {
  using type = float2;
  static __device__ __forceinline__ float2 add(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
  }
};
template <>
struct ScoreVec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

template <int DK, int DV, int G>
__global__ void __launch_bounds__(kF32WarpsOf<DK> * 32, 1)
    paged_mla_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                            const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                            float* __restrict__ o, float* __restrict__ part, int H, int KH,
                            int page, int max_pages, int partition, int n_split,
                            float scale_log2) {
  constexpr int NW = kF32WarpsOf<DK>;
  constexpr int kF32Threads = NW * 32;
  constexpr int KW = kF32KW;              // k-steps of Q K^T of one warp
  constexpr int DW = DV / NW;             // output columns of one warp
  constexpr int DT = DW / 8;              // their 8-column tiles
  constexpr int kSumW = 4 * kNT / NW;     // partial scores a thread sums across the warps
  static_assert(DK == 8 * KW * NW && kNT % 2 == 0 && DV <= DK && DW % 8 == 0 &&
                    (kSumW == 2 || kSumW == 4),
                "shape the MLA 3xTF32 kernel does not tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [kStages][kTile][DK], swizzled
  float4* Sp = reinterpret_cast<float4*>(ring + kStages * kTile * DK);  // [NW][kNT][32]
  float4* Sf = Sp + NW * kNT * 32;                                       // [kNT][32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;  // fragment row: heads grp and grp + 8
  const int quad = lane & 3;  // fragment column
  const int kh = blockIdx.x / kHeadTiles<G>;
  const int g0 = blockIdx.x % kHeadTiles<G> * kM;  // this block's first head of the group
  const int GL = min(kM, G - g0);                     // and its live rows of the M tile
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int B = gridDim.y;
  const int t_begin = split * partition;
  const size_t bh0 = size_t(b) * H + size_t(kh) * G + g0;
  const int* table = block_table + size_t(b) * max_pages;

  // What needs no seq_len goes out before it is read, so the first tiles
  // wait for one load of device memory before their copies, not two: the
  // table entries of this thread's row of each of the first kStages tiles
  // (clamped to the table; a row past seq_len is never copied) and Q.  Q
  // is invariant over the partition: this warp's KW k-steps of its A
  // fragments (rows >= GL zero), split once, stay in registers.
  int pg[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    const int t = t_begin + i * kTile + tid / (kF32Threads / kTile);
    pg[i] = __ldg(table + min(t / page, max_pages - 1));
  }
  const int kw0 = warp * KW;  // this warp's first k-step of Q K^T
  uint32_t qf[KW][4];
#pragma unroll
  for (int k = 0; k < KW; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (grp, quad), (grp + 8, quad), (grp, quad + 4), ...
      const int r = grp + 8 * (i & 1);
      const int d = 8 * (kw0 + k) + quad + 4 * (i >> 1);
      qf[k][i] = r < GL ? __float_as_uint(__ldg(q + (bh0 + r) * DK + d)) : 0u;
    }

  const int t_end = min(seq_lens[b], t_begin + partition);
  float* part_m = part;
  float* part_l = part + size_t(B) * H * n_split;
  float* part_o = part + 2 * size_t(B) * H * n_split;
  if (t_begin >= t_end) {  // nothing of this sequence in the partition
    if (n_split == 1) {
      for (int idx = tid; idx < GL * DV; idx += kF32Threads) o[bh0 * DV + idx] = 0.f;
    } else if (tid < GL) {
      part_m[(bh0 + tid) * n_split + split] = -INFINITY;
      part_l[(bh0 + tid) * n_split + split] = 0.f;
    }
    return;
  }

  const size_t tok_stride = size_t(KH) * DK;
  const size_t page_stride = size_t(page) * tok_stride;
  const float* kbase = kp + size_t(kh) * DK;
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;

  // Every stage is in flight before the first product, each tile a group
  // of its own, committed even when empty (see the bf16 kernel).
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles)
      stage_rows_at<DK, kF32Threads>(ring, kbase, pg[i], page, page_stride, tok_stride, t_begin,
                                     t_end, i);
    repro::cp_async_commit();
  }
  uint32_t qbig[KW][4], qsml[KW][4];
#pragma unroll
  for (int k = 0; k < KW; ++k) repro::split_x4(qf[k], qbig[k], qsml[k]);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // heads grp, grp + 8; the same in every warp
  float l_run[2] = {0.f, 0.f};              // this lane's share of the partition's tokens

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const float* Kt = ring + (it % kStages) * kTile * DK;
    if (it == 0)
      repro::cp_async_wait<kStages - 1>();
    else
      repro::cp_async_wait<kStages - 2>();
    // (A) Tile it is visible to every thread, and every warp is done with
    // tile it - 1, whose stage tile it - 1 + kStages now fills, and with
    // its summed scores.
    __syncthreads();
    if (it >= 1) {
      if (it - 1 + kStages < n_tiles)
        stage_rows<DK, kF32Threads>(ring, kbase, table, page, page_stride, tok_stride,
                                    t_begin, t_end, it - 1 + kStages);
      repro::cp_async_commit();
    }

    // This warp's share of S = Q K^T: 16 heads x all kTile tokens over its
    // KW k-steps.  K's B fragments of two token tiles come by one ldmatrix
    // (b16) from the row-major f32 tile and are split as they are loaded;
    // each product runs over the kNT token tiles before the next starts,
    // big * big and the cross terms into accumulators of their own.
    float s_hi[kNT][4], s_lo[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_hi[n][e] = s_lo[n][e] = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      uint32_t kbig[kNT / 2][4], ksml[kNT / 2][4];  // token tiles 2 np and 2 np + 1
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, Kt + swz<DK, float>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                                   2 * (kw0 + k) + ((lane >> 3) & 1)));
        repro::split_x4(kf, kbig[np], ksml[np]);
      }
      // d[n] += a * (token tile n's b0, b1), over the kNT token tiles
      const auto product = [](float (&d)[kNT][4], const uint32_t (&a)[4],
                              const uint32_t (&kb)[kNT / 2][4]) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          repro::mma_tf32_1688(d[n], a, kb[n / 2][2 * (n & 1)], kb[n / 2][2 * (n & 1) + 1]);
      };
      product(s_lo, qsml[k], kbig);
      product(s_lo, qbig[k], ksml);
      product(s_hi, qbig[k], kbig);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      Sp[(warp * kNT + n) * 32 + lane] =
          make_float4(s_hi[n][0] + s_lo[n][0], s_hi[n][1] + s_lo[n][1], s_hi[n][2] + s_lo[n][2],
                      s_hi[n][3] + s_lo[n][3]);
    __syncthreads();  // (B) every warp's share is written
    // Thread i sums the i-th kSumW-float vector of the scores over the
    // warps' shares, in warp order, and writes it to the summed scores (a
    // warp's share is kF32Threads such vectors).
    {
      using Vec = ScoreVec<kSumW>;
      const auto* src = reinterpret_cast<const typename Vec::type*>(Sp) + tid;
      auto v = src[0];
#pragma unroll
      for (int w = 1; w < NW; ++w) v = Vec::add(v, src[w * kF32Threads]);
      reinterpret_cast<typename Vec::type*>(Sf)[tid] = v;
    }
    __syncthreads();  // (C) the scores are summed

    // Every warp runs the same online softmax over all kTile tokens: no
    // exchange of the max, and the scores of token tile n are this lane's
    // A fragment of k-step n of P V.
    float sc[kNT][4];  // log2-domain scores: heads grp (e = 0, 1), grp + 8 (e = 2, 3)
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float4 v4 = Sf[n * 32 + lane];
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * n + 2 * quad + (e & 1);
        sc[n][e] = t < t_end ? v[e] * scale_log2 : -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx[0] = fmax_nan(mx[0], fmax_nan(sc[n][0], sc[n][1]));
      mx[1] = fmax_nan(mx[1], fmax_nan(sc[n][2], sc[n][3]));
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mu[r] = fmax_nan(m_run[r], mx[r]);  // finite inputs: finite, the tile's first token is seen
      const float corr = repro::ex2_approx(m_run[r] - mu[r]);
      m_run[r] = mu[r];
      l_run[r] *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }

    // O += P V over the tile's tokens, this warp's output columns.  P's A
    // fragment of k-step n takes this lane's keys 2 quad and 2 quad + 1 of
    // token tile n as its columns quad and quad + 4 (the sum over keys
    // takes any order), so V's B fragment b0 = V[2 quad][8 d + grp], b1 =
    // V[2 quad + 1][8 d + grp]: scalar loads of the staged rows (ldmatrix
    // would give b16 halves), split as they are loaded.  Each product runs
    // over the DT independent accumulators before the next starts.
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float p0 = repro::ex2_approx(sc[n][0] - mu[0]);  // (head grp, key 2 quad)
      const float p1 = repro::ex2_approx(sc[n][1] - mu[0]);  // (head grp, key 2 quad + 1)
      const float p2 = repro::ex2_approx(sc[n][2] - mu[1]);  // (head grp + 8, key 2 quad)
      const float p3 = repro::ex2_approx(sc[n][3] - mu[1]);  // (head grp + 8, key 2 quad + 1)
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      const uint32_t pf[4] = {__float_as_uint(p0), __float_as_uint(p2), __float_as_uint(p1),
                              __float_as_uint(p3)};
      uint32_t pbig[4], psml[4];
      repro::split_x4(pf, pbig, psml);
      const int r0 = 8 * n + 2 * quad;
      uint32_t vbig[DT][2], vsml[DT][2];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = warp * DW + 8 * d + grp;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          repro::split_tf32(Kt[swz<DK, float>(r0 + r, col >> 2) + (col & 3)], vbig[d][r],
                            vsml[d][r]);
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) repro::mma_tf32_1688(acc[d], psml, vbig[d][0], vbig[d][1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) repro::mma_tf32_1688(acc[d], pbig, vsml[d][0], vsml[d][1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) repro::mma_tf32_1688(acc[d], pbig, vbig[d][0], vbig[d][1]);
    }
  }

  // Each head's sum over the quad (every warp holds all the tokens').
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = grp + 8 * r;
    if (g >= GL) continue;  // a zero row of the M tile
    const float L = l_run[r];
    const size_t bh = bh0 + g;
    const int col = warp * DW + 2 * quad;
    if (n_split == 1) {
      const float inv = L == 0.f ? 0.f : 1.f / L;  // a NaN sum stays NaN
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(o + bh * DV + col + 8 * d) =
            make_float2(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
    } else {
      float* prow = part_o + (bh * n_split + split) * DV + col;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(prow + 8 * d) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
      if (warp == 0 && quad == 0) {
        part_m[bh * n_split + split] = m_run[r];
        part_l[bh * n_split + split] = L;
      }
    }
  }
}

template <int DK, int DV, int G>
cudaError_t launch_tf32x3(const void* q, const void* kp, const void* bt, const void* sl, void* o,
                          void* part, int B, int H, int KH, int page, int max_pages,
                          int partition, int n_split, float scale, cudaStream_t stream) {
  constexpr size_t smem = tf32x3_smem_bytes<DK>();
  auto kern = paged_mla_tf32x3_kernel<DK, DV, G>;
  // Set once per instance, as for the bf16 kernel: one block an SM.
  static const cudaError_t attr_err = [kern] {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  }();
  cudaError_t err = attr_err;
  if (err != cudaSuccess) return err;
  const dim3 grid(KH * kHeadTiles<G>, B, n_split);
  kern<<<grid, kF32WarpsOf<DK> * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp), static_cast<const int*>(bt),
      static_cast<const int*>(sl), static_cast<float*>(o), static_cast<float*>(part), H, KH, page,
      max_pages, partition, n_split, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<float, DV><<<B * H, DV, 0, stream>>>(static_cast<const float*>(part),
                                                         static_cast<float*>(o), B * H, n_split);
  return cudaGetLastError();
}

// bf16 runs the bf16 tensor-core kernel, f32 the 3xTF32 one.
template <typename T, int DK, int DV, int G>
cudaError_t launch_typed(const void* q, const void* kp, const void* bt, const void* sl, void* o,
                         void* part, int B, int H, int KH, int page, int max_pages,
                         int partition, int n_split, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_mma<DK, DV, G>(q, kp, bt, sl, o, part, B, H, KH, page, max_pages, partition,
                                 n_split, scale, st);
  else
    return launch_tf32x3<DK, DV, G>(q, kp, bt, sl, o, part, B, H, KH, page, max_pages,
                                    partition, n_split, scale, st);
}

// The instances: deepseek-v2-lite's (576, 512) at G = 16 (and 4, in the
// tests), minicpm3-4b's (288, 256) at G = 40.
template <typename T>
cudaError_t launch_group(int hd, int hd_v, int G, const void* q, const void* kp, const void* bt,
                         const void* sl, void* o, void* part, int B, int H, int KH, int page,
                         int max_pages, int partition, int n_split, float scale,
                         cudaStream_t st) {
#define REPRO_MLA_CASE(DK, DV, GG)                                                            \
  if (hd == DK && hd_v == DV && G == GG)                                                      \
    return launch_typed<T, DK, DV, GG>(q, kp, bt, sl, o, part, B, H, KH, page, max_pages,     \
                                       partition, n_split, scale, st);
  REPRO_MLA_CASE(576, 512, 16)
  REPRO_MLA_CASE(576, 512, 4)
  REPRO_MLA_CASE(288, 256, 40)
#undef REPRO_MLA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace mla
}  // namespace

REPRO_EXPORT_ERROR_STRING

// `partials` is f32 scratch of B * H * n_split * (hd_v + 2) elements (unused,
// may be null, when n_split == 1); n_split partitions of `partition` tokens
// must cover the table's max_pages * page.  v_pages' rows are v_tok_stride
// elements apart: KH * hd for pages of their own (hd_v == hd), or, for MLA
// (hd, hd_v of 576, 512 or 288, 256), v_pages is k_pages itself (the values
// are the first hd_v columns of the key rows).  Returns the CUDA error code of the first
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
  if (hd_v < hd) {  // MLA: the values are the first hd_v columns of the key rows
    if (v_pages != k_pages || v_tok_stride != KH * hd) return int(cudaErrorInvalidValue);
    if (dtype == repro::kF32)
      return int(mla::launch_group<float>(hd, hd_v, G, q, k_pages, block_table, seq_lens, o,
                                          partials, B, H, KH, page, max_pages, partition,
                                          n_split, scale, st));
    if (dtype == repro::kBF16)
      return int(mla::launch_group<__nv_bfloat16>(hd, hd_v, G, q, k_pages, block_table,
                                                  seq_lens, o, partials, B, H, KH, page,
                                                  max_pages, partition, n_split, scale, st));
    return int(cudaErrorInvalidValue);
  }
  if (hd_v != hd || v_tok_stride != KH * hd) return int(cudaErrorInvalidValue);
#define REPRO_PAGED_CASE(HD)                                                                  \
  if (hd == HD) {                                                                             \
    if (dtype == repro::kF32)                                                                 \
      return int(launch_group<float, HD>(G, q, k_pages, v_pages, block_table, seq_lens, o,    \
                                         partials, B, H, KH, page, max_pages, partition,      \
                                         n_split, scale, st));                                \
    if (dtype == repro::kBF16)                                                                \
      return int(launch_group<__nv_bfloat16, HD>(G, q, k_pages, v_pages, block_table,         \
                                                 seq_lens, o, partials, B, H, KH, page,       \
                                                 max_pages, partition, n_split, scale, st));  \
  }
  REPRO_PAGED_CASE(128)
  REPRO_PAGED_CASE(64)
  REPRO_PAGED_CASE(80)
  REPRO_PAGED_CASE(256)
#undef REPRO_PAGED_CASE
  return int(cudaErrorInvalidValue);
}
