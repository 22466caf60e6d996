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
// What bounds it on this card.  At the main path's shape (b = 4, S = 2048,
// H = 32, P = 64, G = 1, N = 128, Q = 256) the call writes 101 MB of f32 y
// and states and reads 40 MB of bf16 inputs (77 MB in f32): 0.042 ms at
// 3.35 TB/s (0.053 ms in f32).  Its products are 8.9 GFLOP: C B^T once a
// group (0.27), (C B^T o L) (x dt) and the states once a head (4.31 and
// 4.29): 0.009 ms at the bf16 tensor-core peak, so bf16 is bound by bytes;
// in f32 each multiply is three TF32 products (below), 494.7 / 3 TFLOP/s,
// 0.054 ms, so f32 is bound by operations, just above its bytes (0.132 ms
// on the CUDA cores' 67 TFLOP/s).  Two pairs of kernels, chosen by type,
// one design:
//   * a y kernel: one block of 4 warps per (cell, 64-row query tile, slab
//     of HB heads of one group), each warp owning 16 query rows; HB is the
//     largest divisor of H / G under a cap on HB * P, so C B^T is computed
//     H / (G * HB) times per tile, not H / G.  A loop walks the key tiles on
//     or below the diagonal through a 2-stage cp.async ring of B and the
//     slab's x (the slab's heads are neighbours in memory, so a row is
//     HB * P contiguous elements), behind one barrier a tile; per k-step,
//     S = C B^T on the tensor cores, then for each head of the slab P' = S *
//     exp2(c2[i] - c2[j]) * dt[j] on j <= i (c2 = cum * log2(e);
//     ex2.approx; the mask is compiled only into the diagonal tiles' walk),
//     turned in registers into the A fragment of P' x, so P' never touches
//     shared memory; dt is folded into P', so x goes to the tensor cores as
//     stored.  Every block scans dt itself (one warp per head: a segment a
//     lane, then shuffles); positions past Q get dt = 0 and the last cum,
//     so keys past Q add 0 and no exponent overflows off the diagonal;
//   * a state kernel: one block of 4 warps per (cell, head, 128-row slab of
//     N), 32 rows a warp, walking the chunk's key tiles through a 2-stage
//     ring whose two stages are both in flight while the decays are scanned:
//     state = B^T (w o x), w[q] = dt[q] * exp(cum[Q-1] - cum[q]), w applied
//     in f32 to x's B fragments in registers.  The first slab's block also
//     writes decay and chunk_decay.
//
// bf16 -> `ssd_chunk_y_mma_kernel` then `ssd_chunk_state_mma_kernel`,
//   mma.sync m16n8k16 (bf16 in, f32 out), 64-key tiles:
//   * HB * P <= 256 (128 when N > 128, where C's fragments take twice the
//     registers): 4 heads at P = 64.  C's 64 rows are loaded once, straight
//     from global memory, as the A fragments of C B^T and held in registers
//     for the whole walk;
//   * the ring holds B (keys x N, zero-padded to 128 or 256 columns, so the
//     k-steps of C B^T need no guard) and x raw, each row padded by 16 bytes
//     so ldmatrix has no bank conflicts and a lane's addresses move by
//     constants from one k-step to the next; x's B fragments come by
//     ldmatrix.trans; P' is packed to bf16 pairs (two neighbouring 8-key f32
//     fragments are the A fragment of P' x);
//   * the slab's width is a template argument where HB is the widest the
//     slab may be (the main path), so the head loop carries no guard;
//   * y is staged through the x ring as f32 and leaves in 16-byte rows;
//   * the state kernel takes B^T's A fragments from the staged B tile by
//     ldmatrix.trans, applies w to x's fragments in f32 and repacks them.
//   What is rounded: P' and w o x, to bf16 (x, B and C are bf16 already);
//   every sum is f32.  `ssd_chunk_tiled_ref` (kernels/ssd_scan/ref.py)
//   rounds the same values.  Registers (ptxas -v, sm_90a) at the main
//   path's P = 64, N = 128: `ssd_chunk_y_mma_kernel<64, 8, 4>` 252, no
//   spill (its accumulators alone are 128, C's fragments 32), so two
//   blocks an SM; `ssd_chunk_state_mma_kernel<64>` 128, no spill.
// f32 -> `ssd_chunk_y_tf32x3_kernel` then `ssd_chunk_state_tf32x3_kernel`:
//   both products on the tensor cores as mma.sync m16n8k8 with TF32 inputs,
//   three products per multiply (CUTLASS's "fast accurate f32", as the f32
//   flash kernel takes it): each operand is split into big = tf32(v),
//   rounded to nearest, and small = v - big truncated to TF32
//   (warp_mma.cuh::split_tf32), and a b is big_a big_b + big_a small_b +
//   small_a big_b with f32 accumulators; the pair holds each operand to
//   2^-21 and the dropped small_a small_b is below 2^-22 of |a b|, so the
//   kernels hold f32 to its plain version's limit (1e-4 of scale).  A NaN in
//   x leaves small a NaN, so it reaches y and the states.  What was hard,
//   and what the design does about it:
//   * Registers.  An f32 C fragment is twice a bf16 one, and split into big
//     and small twice again: a warp's 16 rows of C at N = 128 would take 128
//     registers beside the 128 accumulators of 4 heads of 64.  So C is
//     staged once in shared memory (64 rows, raw f32) and each fragment is
//     loaded by ldmatrix and split as C B^T needs it, once per k-step of a
//     key tile, shared by the slab's heads.  B's fragments come the same
//     way; P' is split in registers into the A fragment of P' x (its
//     columns quad and quad + 4 stand for keys 2 quad and 2 quad + 1, as the
//     f32 flash kernel does with P); x's B fragments are scalar loads
//     (ldmatrix.trans would cut each f32 word in two), split as loaded.
//   * Shared memory.  Every f32 tile is twice the bf16 one: a 64-key B tile
//     is 32 KB and the slab's 64 x 256 x tile 64 KB, a 192 KB ring for one
//     block an SM.  The y kernel keeps HB * P <= 256 (4 heads at P = 64)
//     and takes 16-key tiles: C (33,792 B) + 2 stages of B and x (2 x
//     25,088 B) + dt and the decays (12,288 B at Q = 256) = 96,256 B, two
//     blocks (8 warps) an SM; at N = 256 one.  The state kernel takes
//     32-key tiles: 51,200 B of ring.
//   * Measured beside the alternatives (main case, NVIDIA H100 80GB HBM3
//     at 700 W, graph timer, each a patched copy of this file timed in
//     turns with it; the timing script is not kept, PERF.md section 6):
//     this design 0.2925-0.2988 ms (one profiled call: y 210.6 us, state
//     92.0 us); HB * P <= 128 with 16-key tiles 0.3228-0.3294 ms, with
//     32-key tiles 0.3419-0.3483 ms; C's big and small planes staged once
//     (HB * P <= 128, 16-key tiles, 107,520 B) 0.3498-0.3562 ms.  Registers
//     (ptxas -v): `ssd_chunk_y_tf32x3_kernel<64, 16, 4>` 250,
//     `ssd_chunk_state_tf32x3_kernel<64>` 162, no spill (a few instances at
//     P = 16 and 32 spill up to 24 bytes).
//   * Exactness.  Decays come from an f64 scan (each negA * dt is exact
//     there), each cum * log2(e) kept as an f32 pair hi + lo, and a decay's
//     exponent is (hi_i - hi_j) + (lo_i - lo_j): f32 prefix sums reach a
//     few thousand, where one ulp (about 2e-4) would move exp(cum_i - cum_j)
//     by 2e-4 of itself, more than the products' own error.  exp2 is
//     ex2.approx.ftz (about 2 ulp); the mask is as in bf16.  tf32_rna turns
//     the canonical NaN into zero, but the truncated small part keeps it.
//     `ssd_chunk_tiled_ref(..., tf32_products=3)` computes exactly these
//     splits and decays.
// Both pairs take Q up to 8192 (ops.py's MAX_CHUNK), N a multiple of 8 up
// to 256, P in {16, 32, 64, 128} and any H / G.  A y block keeps dt and
// its heads' decays over the whole chunk in shared memory, so the launch
// takes the widest slab whose block fits the card's opt-in limit (227 KB
// on the H100): at P = 16 and H / G = 16 the f32 slab of 16 heads fits to
// Q = 768 at N = 128, and one head's block fits to Q = 9600 at N = 256,
// P = 128 (bf16: 16,256).  Both are bound by latency, not by bytes or
// tensor-core rate: 8 warps an SM, held there by the y kernels' registers
// (in f32 the warps also spend most of their issue slots on fragment loads
// and splits).  wgmma (accumulators split across a warpgroup), TMA and warp
// specialisation are the way from here to the bounds.
#include "common.cuh"
#include "warp_mma.cuh"

namespace {

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

// The dynamic shared memory a block may take on this card once opted in
// (a process drives one card).
inline size_t smem_optin() {
  static const size_t bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return size_t(v);
  }();
  return bytes;
}

// Let the kernel take up to that much dynamic shared memory, and ask for
// the largest carveout, so that two blocks fit an SM.  Callers keep the
// result in a function-local static: once per instance, not every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_optin()));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// Heads of a y block: the largest divisor of H / G with at most
// `max_heads` whose block fits in shared memory (smem(hb) bytes, which
// grow with Q); 0 if not even one head's does.
template <typename Smem>
int slab_heads(int heads_per_group, int max_heads, Smem smem) {
  int hb = 0;
  for (int d = 1; d <= heads_per_group && d <= max_heads; ++d)
    if (heads_per_group % d == 0 && smem(d) <= smem_optin()) hb = d;
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
  static const cudaError_t attr_err = allow_smem(kern);
  if (attr_err != cudaSuccess) return attr_err;
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
  const int hb = slab_heads(H / G, HBMAX, [&](int d) { return y_smem_bytes(Q, NK, P, d); });
  if (hb == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      hb == HBMAX
          ? launch_y<P, NK, HBMAX>(x, dt, A_log, Bm, Cm, y, b, nc, Q, H, G, N, hb, stream)
          : launch_y<P, NK, 0>(x, dt, A_log, Bm, Cm, y, b, nc, Q, H, G, N, hb, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = state_smem_bytes<P>(Q);
  auto kern = ssd_chunk_state_mma_kernel<P>;
  static const cudaError_t attr_err = allow_smem(kern);
  if (attr_err != cudaSuccess) return attr_err;
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

// ---------------------------------------------------------------------------
// f32: three TF32 products on the tensor cores.
namespace tf32x3 {

using tensor_core::kSlabN;
using tensor_core::kThreads;
using tensor_core::kTile;
using tensor_core::kWarps;
using tensor_core::allow_smem;
using tensor_core::slab_heads;
constexpr int kPad = 4;         // f32 words of padding after every staged row
constexpr int kMaxSlab = 256;   // widest slab of heads a y block takes, HB * P
constexpr int kKeys = 16;       // keys per tile of the y kernel's ring
constexpr int kStateKeys = 32;  // keys per tile of the state kernel's ring
constexpr double kLog2e = 1.4426950408889634;

// Start the copy of rows [r0, r0 + ROWS) of an f32 slice whose rows are
// `row_stride` elements apart into a tile of CH 16-byte chunks a row (CH =
// 0: `ch_rt` chunks, known only at run time), rows kPad words longer than
// the data; chunks of rows >= n_rows or of index >= valid_ch are
// zero-filled.  The padding moves each row by 4 banks, so the 8 rows an
// ldmatrix reads, and the rows 2 * quad a warp's scalar fragment loads
// read, fall in different banks.
template <int ROWS, int CH>
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      size_t row_stride, int r0, int n_rows, int ch_rt,
                                      int valid_ch) {
  const int ch = CH ? CH : ch_rt;
  const int ld = 4 * ch + kPad;
  for (int idx = threadIdx.x; idx < ROWS * ch; idx += kThreads) {
    const int r = idx / ch;
    const int c = idx % ch;
    const bool ok = r0 + r < n_rows && c < valid_ch;
    repro::cp_async_16(dst + r * ld + c * 4, ok ? src + size_t(r0 + r) * row_stride + c * 4 : src,
                       ok);
  }
}

// One warp: hi[q] + lo[q] = scale * sum_{t <= q} negA * dts[t] for q < L,
// the sums taken in f64 (where each product negA * dt is exact) and each
// kept as an f32 pair, hi = the f32 nearest the sum, lo = the rest.  The
// decay between two positions is then ((hi_i - hi_j) + (lo_i - lo_j)), to
// a few f32 ulps of the difference, where hi_i - hi_j alone would lose an
// ulp of |hi| (about 2e-4 once the sums reach a few thousand).  Each lane
// sums a contiguous segment, the segment totals are scanned by shuffles,
// then each lane writes its segment's prefixes.  Returns the scaled sum over
// all L as an f32 pair (every lane).
__device__ __forceinline__ float2 warp_cumsum_f64(float* __restrict__ hi, float* __restrict__ lo,
                                                  const float* __restrict__ dts, int L,
                                                  float negA, double scale) {
  const int lane = threadIdx.x & 31;
  const int seg = (L + 31) / 32;
  const int q_lo = min(L, lane * seg);
  const int q_hi = min(L, q_lo + seg);
  const double a = negA;
  double tot = 0.0;
  for (int q = q_lo; q < q_hi; ++q) tot += a * double(dts[q]);
  double incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
  for (int q = q_lo; q < q_hi; ++q) {
    run += a * double(dts[q]);
    const double v = run * scale;
    hi[q] = float(v);
    lo[q] = float(v - double(float(v)));
  }
  const double last = __shfl_sync(0xffffffffu, incl, 31) * scale;
  return make_float2(float(last), float(last - double(float(last))));
}

// The y block's C tile (64 rows of 8 * NK), its ring of B (kKeys x 8 * NK)
// and x (kKeys x hb * P) tiles, then dt and the pair (hi, lo) of the scaled
// cumulative decays of its hb heads.
size_t y_smem_bytes(int Q, int NK, int P, int hb) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  const size_t ldc = 8 * NK + kPad, ldx = size_t(hb) * P + kPad;
  return sizeof(float) * (kTile * ldc + 2 * size_t(kKeys) * (ldc + ldx) + 3 * size_t(hb) * Qp);
}

// y_diag of 64 query rows for a slab of heads of one group.  N <= 8 * NK (B
// and C are zero-padded to 8 * NK columns, so the k-steps of C B^T need no
// guard).  HB > 0: the slab has exactly HB heads; HB = 0: hb_rt heads, at
// most kMaxSlab / P (a guard per head).
template <int P, int NK, int HB>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_y_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                              const float* __restrict__ A_log, const float* __restrict__ Bm,
                              const float* __restrict__ Cm, float* __restrict__ y, int nc, int Q,
                              int H, int G, int N, int hb_rt) {
  constexpr int HBMAX = HB ? HB : kMaxSlab / P;
  constexpr int DT = P / 8;         // 8-wide column tiles of one head's output
  constexpr int NPAD = 8 * NK;      // columns of the C and B tiles
  constexpr int LDC = NPAD + kPad;  // words between their rows
  constexpr int NT = kKeys / 8;     // 8-key column tiles of S = k-steps of P' x
  constexpr int kDG = DT < 4 ? DT : 4;  // output tiles each run of one product covers
  static_assert(NT % 2 == 0, "B fragments come two key tiles at a time");
  static_assert(DT % kDG == 0, "whole groups of output tiles");
  const int hb = HB ? HB : hb_rt;
  const int W = hb * P;
  const int LDX = W + kPad;
  const int Qp = (Q + kTile - 1) / kTile * kTile;

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                   // 64 x LDC
  float* Bs = Cs + kTile * LDC;       // 2 stages of kKeys x LDC
  float* Xs = Bs + 2 * kKeys * LDC;   // 2 stages of kKeys x LDX
  float* dts = Xs + 2 * kKeys * LDX;  // hb x Qp
  float* c2h = dts + hb * Qp;         // hb x Qp: cum * log2(e), hi
  float* c2l = c2h + hb * Qp;         // and lo

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
  const float* xb = x + (t0 * H + h0) * P;
  const float* bb = Bm + (t0 * G + g) * N;
  const float* cb = Cm + (t0 * G + g) * N;
  const int rows_end = q0 + kTile;  // decays are needed on [0, rows_end)
  const int L = min(rows_end, Q);
  const int n_kt = (L + kKeys - 1) / kKeys;  // key tiles on or below the last row
  const int wr0 = q0 + warp * 16;            // this warp's rows: wr0 + grp, wr0 + grp + 8

  // C and tile 0 are in flight while dt loads and the decays are scanned.
  stage<kTile, NPAD / 4>(Cs, cb, bc_row, q0, Q, 0, N / 4);
  stage<kKeys, NPAD / 4>(Bs, bb, bc_row, 0, Q, 0, N / 4);
  stage<kKeys, HB * P / 4>(Xs, xb, x_row, 0, Q, W / 4, W / 4);
  repro::cp_async_commit();

  for (int idx = tid; idx < hb * rows_end; idx += kThreads) {
    const int q = idx / hb;
    const int hh = idx - q * hb;
    dts[hh * Qp + q] = q < Q ? dt[(t0 + q) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  // Positions past Q get dt = 0 and the last decay, so keys past Q add 0
  // and no exponent overflows off the diagonal.
  for (int hh = warp; hh < hb; hh += kWarps) {
    float* ch = c2h + hh * Qp;
    float* cl = c2l + hh * Qp;
    const float2 last =
        warp_cumsum_f64(ch, cl, dts + hh * Qp, L, -expf(A_log[h0 + hh]), kLog2e);
    for (int q = L + lane; q < rows_end; q += 32) {
      ch[q] = last.x;
      cl[q] = last.y;
    }
  }

  float acc[HBMAX][DT][4];
#pragma unroll
  for (int hh = 0; hh < HBMAX; ++hh)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][d][e] = 0.f;
  const float* Cw = Cs + warp * 16 * LDC;  // this warp's 16 rows of C
  const int ri[2] = {wr0 + grp, wr0 + grp + 8};

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kKeys;
    const float* Bt = Bs + (it & 1) * kKeys * LDC;
    const float* Xt = Xs + (it & 1) * kKeys * LDX;
    repro::cp_async_wait<0>();  // tile it (and, at it = 0, C) has landed
    // One barrier a tile: past it every thread's copies of tile it (and, on
    // the first, the decays) are visible, and no warp reads tile it - 1,
    // whose stage the copy of tile it + 1 now fills.
    __syncthreads();
    if (it + 1 < n_kt) {
      const int nxt = (it + 1) & 1;
      stage<kKeys, NPAD / 4>(Bs + nxt * kKeys * LDC, bb, bc_row, k0 + kKeys, Q, 0, N / 4);
      stage<kKeys, HB * P / 4>(Xs + nxt * kKeys * LDX, xb, x_row, k0 + kKeys, Q, W / 4, W / 4);
      repro::cp_async_commit();
    }
    if (k0 > wr0 + 15) continue;  // every key of the tile lies above this warp's rows
    // The tile's products; the causal mask runs only on tiles that cross the
    // warp's diagonal.
    auto walk = [&](auto diag_tag) {
      constexpr bool kDiag = decltype(diag_tag)::value;
      // S = C B^T: 16 rows x kKeys keys, each fragment split as it is loaded;
      // big * big and the two cross terms in separate accumulators.
      float s[NT][4], s_lo[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_lo[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t cf[4], cbig[4], csml[4];
        repro::ldmatrix_x4(cf, Cw + (lane & 15) * LDC + kk * 8 + (lane >> 4) * 4);
        repro::split_x4(cf, cbig, csml);
        uint32_t bbig[NT / 2][4], bsml[NT / 2][4];  // key tiles 2 np and 2 np + 1
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          repro::ldmatrix_x4(bf, Bt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDC +
                                     kk * 8 + ((lane >> 3) & 1) * 4);
          repro::split_x4(bf, bbig[np], bsml[np]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          repro::mma_tf32_1688(s_lo[j], csml, bbig[j / 2][(j & 1) * 2],
                               bbig[j / 2][(j & 1) * 2 + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          repro::mma_tf32_1688(s_lo[j], cbig, bsml[j / 2][(j & 1) * 2],
                               bsml[j / 2][(j & 1) * 2 + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          repro::mma_tf32_1688(s[j], cbig, bbig[j / 2][(j & 1) * 2], bbig[j / 2][(j & 1) * 2 + 1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s_lo[j][e];

#pragma unroll
      for (int hh = 0; hh < HBMAX; ++hh) {
        if (HB || hh < hb) {
          const float* ch = c2h + hh * Qp;
          const float* cl = c2l + hh * Qp;
          const float* dh = dts + hh * Qp;
          const float cih[2] = {ch[ri[0]], ch[ri[1]]};
          const float cil[2] = {cl[ri[0]], cl[ri[1]]};
          // P' = S * exp2(c2[i] - c2[j]) * dt[j] on j <= i, split, as the A
          // fragments of P' x, one k-step per 8-key tile t.  The accumulator
          // gives this lane keys 2 quad and 2 quad + 1, where the A fragment
          // wants keys quad and quad + 4; the sum over keys takes them in any
          // order, so A column quad stands for key 2 quad and column quad + 4
          // for key 2 quad + 1, and x's B fragment reads rows 2 quad and
          // 2 quad + 1 to match.  No shuffle, no shared memory.
          uint32_t pbig[NT][4], psml[NT][4];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int j0 = k0 + 8 * t + 2 * quad;  // keys j0, j0 + 1
            const float2 cjh = *reinterpret_cast<const float2*>(ch + j0);
            const float2 cjl = *reinterpret_cast<const float2*>(cl + j0);
            const float2 dj = *reinterpret_cast<const float2*>(dh + j0);
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float d2 = ((e & 1) ? cih[r] - cjh.y : cih[r] - cjh.x) +
                               ((e & 1) ? cil[r] - cjl.y : cil[r] - cjl.x);
              p[e] = s[t][e] * repro::ex2_approx(d2) * ((e & 1) ? dj.y : dj.x);
              if (kDiag && j0 + (e & 1) > ri[r]) p[e] = 0.f;
            }
            repro::split_tf32(p[0], pbig[t][0], psml[t][0]);  // (row grp, key 2 quad)
            repro::split_tf32(p[2], pbig[t][1], psml[t][1]);  // (row grp + 8, key 2 quad)
            repro::split_tf32(p[1], pbig[t][2], psml[t][2]);  // (row grp, key 2 quad + 1)
            repro::split_tf32(p[3], pbig[t][3], psml[t][3]);  // (row grp + 8, key 2 quad + 1)
          }
          // acc += P' x: x's B fragment b0 = x[2 quad][8 d + grp], b1 =
          // x[2 quad + 1][8 d + grp] of the k-step's 8 keys, by scalar loads
          // (ldmatrix.trans would cut each f32 word in two), split as loaded,
          // kDG output tiles at a time so that each product runs over kDG
          // independent accumulators.
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const float* xr = Xt + (8 * t + 2 * quad) * LDX + hh * P + grp;
#pragma unroll
            for (int d0 = 0; d0 < DT; d0 += kDG) {
              uint32_t xbig[kDG][2], xsml[kDG][2];
#pragma unroll
              for (int gi = 0; gi < kDG; ++gi)
#pragma unroll
                for (int r = 0; r < 2; ++r)
                  repro::split_tf32(xr[r * LDX + (d0 + gi) * 8], xbig[gi][r], xsml[gi][r]);
#pragma unroll
              for (int gi = 0; gi < kDG; ++gi)
                repro::mma_tf32_1688(acc[hh][d0 + gi], psml[t], xbig[gi][0], xbig[gi][1]);
#pragma unroll
              for (int gi = 0; gi < kDG; ++gi)
                repro::mma_tf32_1688(acc[hh][d0 + gi], pbig[t], xsml[gi][0], xsml[gi][1]);
#pragma unroll
              for (int gi = 0; gi < kDG; ++gi)
                repro::mma_tf32_1688(acc[hh][d0 + gi], pbig[t], xbig[gi][0], xbig[gi][1]);
            }
          }
        }
      }
    };
    if (k0 + kKeys - 1 > wr0)
      walk(std::true_type{});
    else
      walk(std::false_type{});
  }

  // Epilogue: each lane's (row, 2 adjacent columns) pairs, 8-byte stores
  // that fill whole 32-byte sectors (the 4 lanes of a quad write a row's 8
  // columns of a tile).
#pragma unroll
  for (int hh = 0; hh < HBMAX; ++hh) {
    if (HB || hh < hb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (ri[r] >= Q) continue;
        float* yrow = y + ((t0 + ri[r]) * H + h0 + hh) * P + 2 * quad;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<float2*>(yrow + 8 * d) =
              make_float2(acc[hh][d][2 * r], acc[hh][d][2 * r + 1]);
      }
    }
  }
}

// The state block's ring of B (kStateKeys keys x 128 rows of N) and x
// (kStateKeys x P) tiles, then w and the pair (hi, lo) of cum over the chunk.
template <int P>
size_t state_smem_bytes(int Q) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  return sizeof(float) * (2 * size_t(kStateKeys) * (kSlabN + kPad + P + kPad) + 3 * size_t(Qp));
}

// Rows [n0, n0 + 128) of one head's (N, P) chunk-end state, 32 a warp:
// state = B^T (w o x), w[q] = dt[q] * exp(cum[Q-1] - cum[q]); the block of
// the first slab also writes the decays.
template <int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                                  const float* __restrict__ A_log, const float* __restrict__ Bm,
                                  float* __restrict__ states, float* __restrict__ decay,
                                  float* __restrict__ chunk_decay, int nc, int Q, int H, int G,
                                  int N) {
  constexpr int DT = P / 8;
  constexpr int LDB = kSlabN + kPad;
  constexpr int LDX = P + kPad;
  constexpr int kDG = DT < 4 ? DT : 4;
  const int Qp = (Q + kTile - 1) / kTile * kTile;

  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                          // 2 stages of kStateKeys keys x 128
  float* Xs = Bs + 2 * kStateKeys * LDB;     // 2 stages of kStateKeys keys x P
  float* ws = Xs + 2 * kStateKeys * LDX;     // dt, then w
  float* ch = ws + Qp;                       // cum, hi
  float* cl = ch + Qp;                       // and lo

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
  const float* xb = x + (t0 * H + h) * P;
  const float* bb = Bm + (t0 * G + g) * N + n0;
  const int b_valid = min(kSlabN, N - n0) / 4;
  const int n_kt = (Q + kStateKeys - 1) / kStateKeys;

  // Both stages of the ring are in flight while the decays are scanned.
  for (int t = 0; t < 2 && t < n_kt; ++t) {
    stage<kStateKeys, kSlabN / 4>(Bs + t * kStateKeys * LDB, bb, bc_row, t * kStateKeys, Q, 0,
                                  b_valid);
    stage<kStateKeys, P / 4>(Xs + t * kStateKeys * LDX, xb, x_row, t * kStateKeys, Q, 0, P / 4);
    repro::cp_async_commit();
  }

  for (int q = tid; q < Q; q += kThreads) ws[q] = dt[(t0 + q) * H + h];
  __syncthreads();
  if (warp == 0) warp_cumsum_f64(ch, cl, ws, Q, -expf(A_log[h]), 1.0);
  __syncthreads();
  const float last_h = ch[Q - 1], last_l = cl[Q - 1];
  for (int q = tid; q < Qp; q += kThreads)
    ws[q] = q < Q ? ws[q] * expf((last_h - ch[q]) + (last_l - cl[q])) : 0.f;
  if (blockIdx.z == 0) {
    for (int q = tid; q < Q; q += kThreads) decay[(t0 + q) * H + h] = expf(ch[q] + cl[q]);
    if (tid == 0) chunk_decay[size_t(cell) * H + h] = expf(last_h + last_l);
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
    const int k0 = it * kStateKeys;
    const float* Bt = Bs + (it & 1) * kStateKeys * LDB;
    const float* Xt = Xs + (it & 1) * kStateKeys * LDX;
    if (it + 1 < n_kt)
      repro::cp_async_wait<1>();  // tile it has landed, tile it + 1 may be in flight
    else
      repro::cp_async_wait<0>();
    __syncthreads();  // tile it visible to all; on the first, w too
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kStateKeys / 8; ++ks) {
        // B^T's A fragments of the warp's two 16-row tiles, split: rows n
        // (grp, grp + 8), keys 2 quad (A column quad) and 2 quad + 1 (A
        // column quad + 4), by scalar loads from the (keys, n) tile.
        const float* br = Bt + (ks * 8 + 2 * quad) * LDB + nb + grp;
        uint32_t abig[2][4], asml[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          repro::split_tf32(br[16 * m], abig[m][0], asml[m][0]);
          repro::split_tf32(br[16 * m + 8], abig[m][1], asml[m][1]);
          repro::split_tf32(br[LDB + 16 * m], abig[m][2], asml[m][2]);
          repro::split_tf32(br[LDB + 16 * m + 8], abig[m][3], asml[m][3]);
        }
        const float2 wv = *reinterpret_cast<const float2*>(ws + k0 + ks * 8 + 2 * quad);
        const float* xr = Xt + (ks * 8 + 2 * quad) * LDX + grp;
#pragma unroll
        for (int d0 = 0; d0 < DT; d0 += kDG) {
          uint32_t xbig[kDG][2], xsml[kDG][2];  // w o x, split
#pragma unroll
          for (int gi = 0; gi < kDG; ++gi) {
            repro::split_tf32(xr[(d0 + gi) * 8] * wv.x, xbig[gi][0], xsml[gi][0]);
            repro::split_tf32(xr[LDX + (d0 + gi) * 8] * wv.y, xbig[gi][1], xsml[gi][1]);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int gi = 0; gi < kDG; ++gi)
              repro::mma_tf32_1688(acc[m][d0 + gi], asml[m], xbig[gi][0], xbig[gi][1]);
#pragma unroll
            for (int gi = 0; gi < kDG; ++gi)
              repro::mma_tf32_1688(acc[m][d0 + gi], abig[m], xsml[gi][0], xsml[gi][1]);
#pragma unroll
            for (int gi = 0; gi < kDG; ++gi)
              repro::mma_tf32_1688(acc[m][d0 + gi], abig[m], xbig[gi][0], xbig[gi][1]);
          }
        }
      }
    }
    if (it + 2 < n_kt) {
      __syncthreads();  // every warp is done with stage it & 1
      stage<kStateKeys, kSlabN / 4>(Bs + (it & 1) * kStateKeys * LDB, bb, bc_row,
                                    k0 + 2 * kStateKeys, Q, 0, b_valid);
      stage<kStateKeys, P / 4>(Xs + (it & 1) * kStateKeys * LDX, xb, x_row, k0 + 2 * kStateKeys,
                               Q, 0, P / 4);
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
  auto kern = ssd_chunk_y_tf32x3_kernel<P, NK, HB>;
  static const cudaError_t attr_err = allow_smem(kern);
  if (attr_err != cudaSuccess) return attr_err;
  kern<<<dim3(b * nc, H / hb, (Q + kTile - 1) / kTile), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), nc, Q, H, G, N, hb);
  return cudaGetLastError();
}

template <int P, int NK>
cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, void* y, void* states, void* decay, void* chunk_decay, int b,
                   int nc, int Q, int H, int G, int N, cudaStream_t stream) {
  constexpr int HBMAX = kMaxSlab / P;
  const int hb = slab_heads(H / G, HBMAX, [&](int d) { return y_smem_bytes(Q, NK, P, d); });
  if (hb == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      hb == HBMAX
          ? launch_y<P, NK, HBMAX>(x, dt, A_log, Bm, Cm, y, b, nc, Q, H, G, N, hb, stream)
          : launch_y<P, NK, 0>(x, dt, A_log, Bm, Cm, y, b, nc, Q, H, G, N, hb, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = state_smem_bytes<P>(Q);
  auto kern = ssd_chunk_state_tf32x3_kernel<P>;
  static const cudaError_t attr_err = allow_smem(kern);
  if (attr_err != cudaSuccess) return attr_err;
  kern<<<dim3(b * nc, H, (N + kSlabN - 1) / kSlabN), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(Bm),
      static_cast<float*>(states), static_cast<float*>(decay), static_cast<float*>(chunk_decay),
      nc, Q, H, G, N);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(const void* x, const void* dt, const void* A_log, const void* Bm,
                     const void* Cm, void* y, void* states, void* decay, void* chunk_decay,
                     int b, int nc, int Q, int H, int G, int N, cudaStream_t st) {
  if (N <= 128)
    return launch<P, 16>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G, N,
                         st);
  return launch<P, 32>(x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc, Q, H, G, N,
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

}  // namespace tf32x3
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
    return int(tf32x3::launch_p(P, x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b, nc,
                                Q, H, G, N, st));
  if (dtype == repro::kBF16)
    return int(tensor_core::launch_p(P, x, dt, A_log, Bm, Cm, y, states, decay, chunk_decay, b,
                                     nc, Q, H, G, N, st));
  return int(cudaErrorInvalidValue);
}
