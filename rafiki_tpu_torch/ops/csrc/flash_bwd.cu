// Backward flash attention for NVIDIA Hopper (sm_90a), written by hand:
// dQ (K2) and dK/dV (K3).
//
// Replaces the TPU kernels of rafiki_tpu/ops/flash_attention.py, launched by
// _flash_backward through pl.pallas_call:
//   - _dq_kernel:  dq = scale * sum_j [P o (dO V^T - delta)] K      (K2)
//   - _dkv_kernel: dv = sum_i P^T dO,
//                  dk = scale * sum_i [P o (dO V^T - delta)]^T Q    (K3)
// with P = exp(scale * Q K^T - lse) recomputed from the forward's per-row
// logsumexp (flash_fwd.cu, stored compact as (B*H, Sq) f32) and
// delta = rowsum(dO o O) in f32, which the JAX package computes outside
// Pallas. Here the bf16 K2 takes delta itself from the forward's f32 output
// and writes it for K3, in place of three PyTorch passes over it; the f32
// K2 reads it (computed in PyTorch). Scores, P and dS never leave the SM;
// dq, dk and dv are accumulated in f32 and written once in the input type.
//
// Semantics kept from the JAX kernels:
//   - end-aligned causal mask: query i sees key j iff j <= i + (Skv - Sq);
//   - no padded copies: the TPU zero-pads q, k, v, dO and O to the tile and
//     relies on zero rows contributing 0. Here the ragged edges are masked
//     in the kernels: tiles arrive zero-filled past the end, query rows
//     >= Sq get lse = +inf (so P = 0) and delta = 0, key columns >= Skv get
//     P = 0 explicitly where they meet a query row that is kept, and
//     nothing is read or written out of bounds;
//   - dead rows: a query row that sees no key has lse = +inf, so P = 0
//     there (exp(s - inf) = 0; s is always finite, so no inf - inf arises),
//     its dq is exactly 0 and it adds nothing to dk or dv;
//   - causal skipping: K2 skips kv tiles past the band of its q tile, K3
//     skips q tiles before the band of its kv tile (a kv tile no query sees
//     writes dk = dv = 0).
//
// Design. The TPU carries dq across the kv grid axis, and dk/dv across the q
// grid axis, in VMEM scratch; Hopper runs blocks in no order, so each
// gradient tile is owned by one CUDA block that loops over the other axis
// itself. No atomics: every output element is written by one thread, and the
// sums run in a fixed order, so the gradients are deterministic.
//
//   - bf16 (the training path), every head dim: as K1 (flash_fwd.cu), a
//     block is one producer warp and one consumer warpgroup; every tile is
//     64 rows, loaded by TMA through 4-d maps over (Dh, S, H, B) built from
//     the tensors' own strides (so q, k, v and dO are read as the
//     projection's strided views, and dq, dk, dv written in the layout the
//     wrapper gives them), swizzled over min(2 Dh, 128) bytes, with full
//     and empty mbarriers per ring stage. All products are wgmma (bf16 in,
//     f32 accumulate); the first two of a tile read both operands K-major
//     from shared memory, the others take P or dS from registers (the f32
//     accumulators of the first products, packed to bf16, are already the
//     A operand's layout) and read their B MN-major, as loaded. dS is
//     split into two bf16 operands, dS rounded and what the rounding left
//     (hopper::split_bf16), and dS K (dS^T Q) is the sum of their two
//     products: dS = P o (dP - delta) is a small difference wherever
//     attention is near uniform, its row sums are 0, and dQ (dK) is that
//     difference times the keys' (queries') spread about their common
//     component: with dS rounded to bf16 BERT-base's per-layer dQ at its
//     initialization lands up to 1.0% from exact attention of the same
//     inputs (dK 0.17%), split 0.031% (dK 0.0006%; plain bf16 attention:
//     1.3%, 3.6%), with delta taken as flash_fwd.cu says
//     (scripts/torch_attention_rounding.py, CPU). The TPU kernels take
//     these products in f32. P^T dO takes P rounded, as plain bf16
//     attention's P V and its gradient do: P >= 0, nothing cancels.
//     The epilogue stages the gradients in bf16 over the resident tiles and
//     writes them with TMA stores, rows past S dropped by the map.
//       K2: one block per (b*h, 64-row q tile). The producer loads Q and dO
//     once and streams 64-key K and V tiles through kStages = 3 stages.
//     The consumers take their rows' lse from device memory once and delta
//     as rowsum(dO o O) from the forward's f32 output: each lane loads a
//     quarter of its two rows of O while the tiles arrive, multiplies it
//     with the dO tile in shared memory, and the row's four lanes add up
//     (the block owns its rows, so delta is written once, for K3). Then
//     per kv tile S = Q K^T, dP = dO V^T, P and dS = P o (dP - delta) in
//     registers, and dQ += dS K (K is the MN-major B; two products). The
//     last kv tile is narrowed to its keys rounded up to 16, as in K1.
//       K3: one block per (b*h, 64-key kv tile). The producer loads K and V
//     once and streams 64-row Q and dO tiles with their lse and delta: the
//     producer warp's lanes write lse * log2(e) and delta (+inf and 0 past
//     Sq) beside the tiles, and each lane arrives on the stage's full
//     barrier, whose transaction bytes lane 0 set before the TMA loads.
//     The consumers compute the transposed scores directly, S^T = K Q^T and
//     dP^T = V dO^T, so P^T and dS^T land in the accumulator layout (lse
//     and delta per column, broadcast from shared memory), then dV += P^T
//     dO and dK += dS^T Q (two products) with dO and Q as the MN-major B.
//     dK and dV stay in f32 registers for the whole loop (64 a thread at
//     Dh = 64). The last q tile is narrowed to its rows rounded up to 16
//     (16 for the 4 rows past 192 at S = 196).
//   - f32: scalar FMAs on the CUDA cores, as in flash_fwd.cu (the tensor
//     cores would round to TF32), contiguous inputs. D / 16 adjacent
//     threads of a warp own one query row (K2) or one key (K3), 16
//     dimensions each; dot products are 16 FMAs and log2(D / 16) shuffles.
//     Tiles are runtime sizes here.
//
// Bound. At the ViT-B/16 training shape (B*H = 768, S = 196, Dh = 64, bf16)
// K2 must read q, k, v, dO, lse and the f32 output and write dq and delta
// (136.6 MB; 41 us at 3.35 TB/s) and K3 read q, k, v, dO, lse and delta
// and write dk, dv (116.8 MB; 35 us); their 15.1 and 18.9 GFLOP (the
// split dS products counted) take 15 and 19 us at the bf16 tensor-core
// peak, so both are bound by bytes. Each
// block re-reads the other axis's tiles of its head (K2: K and V; K3: Q
// and dO, 4 times at S = 196), which hit L2; the producer keeps the next
// tile's loads in flight while the consumers compute, and no thread spends
// instructions on addresses or fragment gathers. What is left is each
// tile's serial chain in the consumer (products, wait, exponentials,
// products, wait), which the other blocks on the SM hide only in part:
// K3's two f32 accumulators hold it to 2 blocks an SM at Dh = 64 (K2: 3;
// forcing 3 and 4 spilled and was slower; setmaxnreg, which moves
// registers between warpgroups, has no producer warpgroup to take them
// from), and at S = 196 the fourth tile of 4 rows (K2) or keys (K3) costs
// a block of its own (at S = 192, K3 takes 21% less time and K2 11%).
// Measured times: PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kInf = __builtin_huge_valf();  // +inf

// Whether query `row` sees key `j`: both inside their ragged edges and,
// when causal, j on or below the end-aligned diagonal (off = Skv - Sq).
__device__ __forceinline__ bool visible(int j, int row, int sq, int skv,
                                        int off, int causal) {
  return j < skv && row < sq && (!causal || j <= row + off);
}

// One past the last key a q tile of `rows` rows from q0 may see.
__device__ __forceinline__ int kv_tile_end(int q0, int rows, int sq, int skv,
                                           int off, int causal) {
  if (!causal) return skv;
  const int q_last = min(q0 + rows, sq) - 1;
  return max(0, min(skv, q_last + off + 1));
}

// The first q tile (a multiple of `bq`) with a row that may see a key of the
// kv tile starting at k0; >= sq when no row does.
__device__ __forceinline__ int q_tile_begin(int k0, int bq, int off,
                                            int causal) {
  if (!causal) return 0;
  const int first = k0 - off;  // the first row that sees key k0
  return first <= 0 ? 0 : (first / bq) * bq;
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kTile = 64;      // rows of every tile: the M of every wgmma
constexpr int kStages = 3;     // streamed tiles in flight
constexpr int kThreads = 160;  // a consumer warpgroup and a producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 bodies for head dim D, as byte offsets from a
// 1024-byte aligned base (every region a multiple of 1024 bytes): the two
// resident tiles (K2: Q, dO; K3: K, V), then kStages stages of the two
// streamed tiles (K2: K, V; K3: Q, dO). A row of 2 D bytes is swizzled over
// min(2 D, 128) bytes and kept as panels of 128-byte rows when wider. The
// epilogue stages the bf16 gradients over the resident tiles.
template <int D>
struct Bwd {
  static constexpr int kSw = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kPanelCols = kSw / 2;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kTileBytes = kTile * 2 * D;
  static constexpr int kStage0 = 2 * kTileBytes;
  static constexpr int kSmemBytes =
      kStage0 + kStages * 2 * kTileBytes + 1024;  // + alignment slack
};

// K-major operand: k step kk (16 columns, 32 bytes) of a 64-row tile; a row
// wider than the swizzle continues in the next panel
template <int Sw>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return hopper::smem_desc<Sw>(
      tile + (kk * 32 / Sw) * kTile * Sw + kk * 32 % Sw, 16, 8 * Sw);
}

// MN-major B: rows 16 kk .. 16 kk + 15 (its k step) of a 64-row tile, all
// columns; the leading offset steps from panel to panel along N
template <int Sw>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return hopper::smem_desc<Sw>(tile + kk * 16 * Sw, kTile * Sw, 8 * Sw);
}

// s = A1 B1^T and t = A2 B2^T over k = D, N columns: the A tiles' 64 rows
// and the B tiles' first N rows, all K-major. Returns when both are done.
template <int D, int Sw, int N>
__device__ __forceinline__ void two_products(float (&s)[N / 2],
                                             float (&t)[N / 2], uint32_t a1,
                                             uint32_t b1, uint32_t a2,
                                             uint32_t b2) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::wgmma_ss<N>(s, k_major<Sw>(a1, kk), k_major<Sw>(b1, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::wgmma_ss<N>(t, k_major<Sw>(a2, kk), k_major<Sw>(b2, kk), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
}

// K2's P and dS for this thread's rows r0 and r0 + 8 (lse2: the rows' lse
// in log2 units) over a kv tile of N keys from kv0, dS split into bf16
// (hopper::split_bf16) straight into the A operands of dS K (k step kk is
// S's n blocks 2 kk and 2 kk + 1): `dsa` rounded, `dsl` its remainder.
// Where kMasked, keys past Skv or above the causal band get P = 0.
template <bool kMasked, int N>
__device__ __forceinline__ void dq_scores(const float (&s)[N / 2],
                                          const float (&dp)[N / 2],
                                          uint32_t (&dsa)[N / 16][4],
                                          uint32_t (&dsl)[N / 16][4],
                                          const float (&lse2)[2],
                                          const float (&dlt)[2], int kv0,
                                          int r0, int t4, int sq, int skv,
                                          int off, int causal,
                                          float scale_log2) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i >> 1) & 1;  // a row spans the 4 lanes t4
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = hopper::ex2(fmaf(s[i + e], scale_log2, -lse2[r]));
      if (kMasked && !visible(kv0 + (i >> 2) * 8 + 2 * t4 + e, r0 + 8 * r,
                              sq, skv, off, causal)) {
        p = 0.f;
      }
      ds[e] = p * (dp[i + e] - dlt[r]);
    }
    const int at = ((i >> 2) & 1) * 2 + r;
    hopper::split_bf16(ds[0], ds[1], dsa[i >> 3][at], dsl[i >> 3][at]);
  }
}

// One kv tile of N keys for K2's consumers: S = Q K^T, dP = dO V^T, dS, and
// dQ += dS K as two products, of dS rounded and of its remainder. A tile
// inside the ragged edge and, when causal, wholly on or below the band for
// every row of the q tile needs no mask.
template <int D, int Sw, int N>
__device__ __forceinline__ void dq_tile(uint32_t qt, uint32_t dot,
                                        uint32_t kt, uint32_t vt,
                                        float (&dq)[D / 2],
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], int kv0,
                                        int q0, int r0, int t4, int sq,
                                        int skv, int off, int causal,
                                        float scale_log2) {
  float s[N / 2];  // the first k step overwrites s and dp
  float dp[N / 2];
  two_products<D, Sw, N>(s, dp, qt, kt, dot, vt);
  uint32_t dsa[N / 16][4];
  uint32_t dsl[N / 16][4];
  if (kv0 + N > skv || (causal && kv0 + N - 1 > q0 + off)) {
    dq_scores<true, N>(s, dp, dsa, dsl, lse2, dlt, kv0, r0, t4, sq, skv,
                       off, causal, scale_log2);
  } else {
    dq_scores<false, N>(s, dp, dsa, dsl, lse2, dlt, kv0, r0, t4, sq, skv,
                        off, causal, scale_log2);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    hopper::wgmma_rs<D>(dq, dsa[kk], mn_major<Sw>(kt, kk));
    hopper::wgmma_rs<D>(dq, dsl[kk], mn_major<Sw>(kt, kk));
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
}

// K3's P^T and dS^T for this thread's keys j0 and j0 + 8 over a q tile of N
// rows from q0 (the columns here), each column's lse (log2 units) and
// delta read from shared memory, packed to bf16 into the A operands of
// P^T dO (`pa`) and dS^T Q, dS^T split (hopper::split_bf16) into `dsa`
// rounded and `dsl` its remainder. Where kMasked, pairs above the causal
// band get P = 0; rows past Sq need no mask (lse = +inf, delta = 0).
template <bool kMasked, int N>
__device__ __forceinline__ void dkv_scores(
    const float (&s)[N / 2], const float (&dp)[N / 2],
    uint32_t (&pa)[N / 16][4], uint32_t (&dsa)[N / 16][4],
    uint32_t (&dsl)[N / 16][4], const float* lse2_s, const float* delta_s,
    int q0, int j0, int t4, int sq, int skv, int off, int causal,
    float scale_log2) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int c = (i >> 2) * 8 + 2 * t4;  // the first of two columns
    const float2 l = *reinterpret_cast<const float2*>(lse2_s + c);
    const float2 d = *reinterpret_cast<const float2*>(delta_s + c);
    float p0 = hopper::ex2(fmaf(s[i], scale_log2, -l.x));
    float p1 = hopper::ex2(fmaf(s[i + 1], scale_log2, -l.y));
    if (kMasked) {
      const int j = j0 + 8 * r;
      if (!visible(j, q0 + c, sq, skv, off, causal)) p0 = 0.f;
      if (!visible(j, q0 + c + 1, sq, skv, off, causal)) p1 = 0.f;
    }
    const int at = ((i >> 2) & 1) * 2 + r;
    pa[i >> 3][at] = hopper::pack_bf16(p0, p1);
    hopper::split_bf16(p0 * (dp[i] - d.x), p1 * (dp[i + 1] - d.y),
                       dsa[i >> 3][at], dsl[i >> 3][at]);
  }
}

// One q tile of N rows for K3's consumers: S^T = K Q^T, dP^T = V dO^T, P^T
// and dS^T, then dV += P^T dO and dK += dS^T Q (two products, of dS^T
// rounded and of its remainder). A tile wholly on or below
// the band for every key of the block needs no mask.
template <int D, int Sw, int N>
__device__ __forceinline__ void dkv_tile(uint32_t kt, uint32_t vt,
                                         uint32_t qt, uint32_t dot,
                                         float (&dk)[D / 2],
                                         float (&dv)[D / 2],
                                         const float* lse2_s,
                                         const float* delta_s, int q0,
                                         int k0, int j0, int t4, int sq,
                                         int skv, int off, int causal,
                                         float scale_log2) {
  float s[N / 2];
  float dp[N / 2];
  two_products<D, Sw, N>(s, dp, kt, qt, vt, dot);
  uint32_t pa[N / 16][4];
  uint32_t dsa[N / 16][4];
  uint32_t dsl[N / 16][4];
  if (causal && k0 + kTile - 1 > q0 + off) {
    dkv_scores<true, N>(s, dp, pa, dsa, dsl, lse2_s, delta_s, q0, j0, t4,
                        sq, skv, off, causal, scale_log2);
  } else {
    dkv_scores<false, N>(s, dp, pa, dsa, dsl, lse2_s, delta_s, q0, j0, t4,
                         sq, skv, off, causal, scale_log2);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    hopper::wgmma_rs<D>(dv, pa[kk], mn_major<Sw>(dot, kk));
    hopper::wgmma_rs<D>(dk, dsa[kk], mn_major<Sw>(qt, kk));
    hopper::wgmma_rs<D>(dk, dsl[kk], mn_major<Sw>(qt, kk));
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
}

// The epilogue of both kernels: this thread's rows of a 64 x D f32
// accumulator, times `scale`, as bf16 into the swizzled tile at byte
// `offset` from the aligned base `gbase`, as a TMA store reads it.
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* gbase, uint32_t offset,
                                           const float (&acc)[D / 2],
                                           float scale, int row_in, int t4) {
  constexpr int Sw = Bwd<D>::kSw;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t at = offset + (c * 2 / Sw) * kTile * Sw +
                          (row_in + 8 * r) * Sw + c * 2 % Sw;
      *reinterpret_cast<uint32_t*>(gbase + hopper::swizzle<Sw>(at)) =
          hopper::pack_bf16(acc[4 * j + 2 * r] * scale,
                            acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// TMA-store the staged 64-row tile at byte `tile` to rows row0.. of head
// (b, h) through `map`, panel by panel (one thread)
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t tile, int row0, int h,
                                           int b) {
  using G = Bwd<D>;
  for (int p = 0; p < G::kPanels; ++p) {
    hopper::tma_store_4d(map, tile + p * kTile * G::kSw, p * G::kPanelCols,
                         row0, h, b);
  }
}

// TMA-load a 64-row tile from rows row0.. of head (b, h), panel by panel
// (one thread), completing on `bar`
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t tile, uint64_t* bar,
                                          int row0, int h, int b) {
  using G = Bwd<D>;
  for (int p = 0; p < G::kPanels; ++p) {
    hopper::tma_load_4d(tile + p * kTile * G::kSw, map, bar,
                        p * G::kPanelCols, row0, h, b);
  }
}

// K2: one block per (b*h, q tile of 64 rows); grid.x = B*H * q tiles, q
// tile fastest, so the tiles of one head run side by side and share its K/V
// in L2. Warps 0-3 are the consumer warpgroup, warp 4 the producer.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap dq_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ o32,
                              float* __restrict__ delta, int heads,
                              int sq, int skv, float scale, float scale_log2,
                              int causal) {
  using G = Bwd<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t kv_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);

  const int q_tiles = (sq + kTile - 1) / kTile;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int off = skv - sq;  // end-aligned causal offset
  const int kv_end = kv_tile_end(q0, kTile, sq, skv, off, causal);
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], 4);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: Q and dO once, then the K/V tiles through the ring; rows
    // past S arrive as zeros and count in the expected bytes
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&q_full, 2 * G::kTileBytes);
      load_tile<D>(&q_map, base, &q_full, q0, h, b);
      load_tile<D>(&do_map, base + G::kTileBytes, &q_full, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) {
          hopper::mbar_wait(&kv_empty[s], (t / kStages - 1) & 1);
        }
        hopper::mbar_arrive_expect_tx(&kv_full[s], 2 * G::kTileBytes);
        const uint32_t kt = base + G::kStage0 + s * 2 * G::kTileBytes;
        load_tile<D>(&k_map, kt, &kv_full[s], t * kTile, h, b);
        load_tile<D>(&v_map, kt + G::kTileBytes, &kv_full[s], t * kTile, h,
                     b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are row_in and row_in + 8 of
  // the tile; rows past Sq get lse = +inf (P = 0) and delta = 0
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row_in = 16 * warp + g;
  const int r0 = q0 + row_in;
  float lse2[2];
  // this lane's quarter of its rows of O, for delta
  constexpr int kQuarter = D / 4;
  float2 o[2][kQuarter / 2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < sq ? lse[(int64_t)bh * sq + row] * kLog2e : kInf;
    const float* o_row = o32 + ((int64_t)bh * sq + row) * D + t4 * kQuarter;
#pragma unroll
    for (int i = 0; i < kQuarter / 2; ++i) {
      o[r][i] = row < sq ? reinterpret_cast<const float2*>(o_row)[i]
                         : make_float2(0.f, 0.f);
    }
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const uint32_t qt = base;
  const uint32_t dot = base + G::kTileBytes;
  hopper::mbar_wait(&q_full, 0);
  // delta = rowsum(dO o O) in f32, dO read from its (swizzled) tile: each
  // lane t4 sums a quarter of the columns, the four lanes of a row add up;
  // written once, for K3 (rows past Sq: O and dO are 0, so delta = 0)
  float dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kQuarter / 2; ++i) {
      const int c = t4 * kQuarter + 2 * i;
      const uint32_t at = G::kTileBytes + (c * 2 / G::kSw) * kTile * G::kSw +
                          (row_in + 8 * r) * G::kSw + c * 2 % G::kSw;
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              gbase + hopper::swizzle<G::kSw>(at)));
      sum = fmaf(d.x, o[r][i].x, fmaf(d.y, o[r][i].y, sum));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dlt[r] = sum;
    const int row = r0 + 8 * r;
    if (t4 == 0 && row < sq) delta[(int64_t)bh * sq + row] = sum;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&kv_full[s], (t / kStages) & 1);
    const uint32_t kt = base + G::kStage0 + s * 2 * G::kTileBytes;
    const uint32_t vt = kt + G::kTileBytes;
    const int kv0 = t * kTile;
    // the last tile narrowed to its keys, rounded up to 16
    switch (min(kTile, kv_end - kv0 + 15) / 16) {
      case 1:
        dq_tile<D, G::kSw, 16>(qt, dot, kt, vt, dq, lse2, dlt, kv0, q0, r0,
                               t4, sq, skv, off, causal, scale_log2);
        break;
      case 2:
        dq_tile<D, G::kSw, 32>(qt, dot, kt, vt, dq, lse2, dlt, kv0, q0, r0,
                               t4, sq, skv, off, causal, scale_log2);
        break;
      case 3:
        dq_tile<D, G::kSw, 48>(qt, dot, kt, vt, dq, lse2, dlt, kv0, q0, r0,
                               t4, sq, skv, off, causal, scale_log2);
        break;
      default:
        dq_tile<D, G::kSw, 64>(qt, dot, kt, vt, dq, lse2, dlt, kv0, q0, r0,
                               t4, sq, skv, off, causal, scale_log2);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&kv_empty[s]);  // the stage is free
  }

  // epilogue: dq over the Q tile (every product that read it is done in
  // all four warps), then one TMA store of whole rows, those past Sq dropped
  hopper::named_barrier_sync(1, 128);
  stage_rows<D>(gbase, 0, dq, scale, row_in, t4);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 128);
  if (threadIdx.x == 0) {
    store_tile<D>(&dq_map, base, q0, h, b);
    hopper::tma_store_commit_and_wait();
  }
}

// K3: one block per (b*h, kv tile of 64 keys); grid.x = B*H * kv tiles, kv
// tile fastest, so the tiles of one head share its Q/dO in L2. Warps 0-3
// are the consumer warpgroup, warp 4 the producer. At Dh = 64 the two f32
// accumulators and the two score tiles fit 2 blocks an SM (Dh = 128: 1).
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap dk_map,
                               const __grid_constant__ CUtensorMap dv_map,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, int heads,
                               int sq, int skv, float scale, float scale_log2,
                               int causal) {
  using G = Bwd<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t q_full[kStages];
  __shared__ __align__(8) uint64_t q_empty[kStages];
  // each stage's lse (log2 units) and delta, one per q row
  __shared__ __align__(16) float lse2_s[kStages][kTile];
  __shared__ __align__(16) float delta_s[kStages][kTile];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);

  const int kv_tiles = (skv + kTile - 1) / kTile;
  const int bh = blockIdx.x / kv_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = (blockIdx.x % kv_tiles) * kTile;
  const int off = skv - sq;  // end-aligned causal offset
  const int q_begin = q_tile_begin(k0, kTile, off, causal);
  const int n_tiles = q_begin < sq ? (sq - q_begin + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&q_full[s], 32);  // every producer lane
      hopper::mbar_init(&q_empty[s], 4);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: K and V once, then the Q/dO tiles through the ring, each
    // stage with its rows' lse and delta written by the lanes
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&kv_full, 2 * G::kTileBytes);
      load_tile<D>(&k_map, base, &kv_full, k0, h, b);
      load_tile<D>(&v_map, base + G::kTileBytes, &kv_full, k0, h, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int q0 = q_begin + t * kTile;
      if (t >= kStages) {
        hopper::mbar_wait(&q_empty[s], (t / kStages - 1) & 1);
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&q_full[s], 2 * G::kTileBytes);
        const uint32_t qt = base + G::kStage0 + s * 2 * G::kTileBytes;
        load_tile<D>(&q_map, qt, &q_full[s], q0, h, b);
        load_tile<D>(&do_map, qt + G::kTileBytes, &q_full[s], q0, h, b);
      }
      for (int c = lane; c < kTile; c += 32) {
        const int row = q0 + c;
        lse2_s[s][c] = row < sq ? lse[(int64_t)bh * sq + row] * kLog2e : kInf;
        delta_s[s][c] = row < sq ? delta[(int64_t)bh * sq + row] : 0.f;
      }
      hopper::mbar_arrive(&q_full[s]);  // releases this lane's writes
    }
    return;
  }

  // the consumer warpgroup: this thread's keys are j0 and j0 + 8
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row_in = 16 * warp + g;
  const int j0 = k0 + row_in;
  float dk[D / 2];
  float dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t kt = base;
  const uint32_t vt = base + G::kTileBytes;
  hopper::mbar_wait(&kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int q0 = q_begin + t * kTile;
    hopper::mbar_wait(&q_full[s], (t / kStages) & 1);
    const uint32_t qt = base + G::kStage0 + s * 2 * G::kTileBytes;
    const uint32_t dot = qt + G::kTileBytes;
    // the last tile narrowed to its rows, rounded up to 16
    switch (min(kTile, sq - q0 + 15) / 16) {
      case 1:
        dkv_tile<D, G::kSw, 16>(kt, vt, qt, dot, dk, dv, lse2_s[s],
                                delta_s[s], q0, k0, j0, t4, sq, skv, off,
                                causal, scale_log2);
        break;
      case 2:
        dkv_tile<D, G::kSw, 32>(kt, vt, qt, dot, dk, dv, lse2_s[s],
                                delta_s[s], q0, k0, j0, t4, sq, skv, off,
                                causal, scale_log2);
        break;
      case 3:
        dkv_tile<D, G::kSw, 48>(kt, vt, qt, dot, dk, dv, lse2_s[s],
                                delta_s[s], q0, k0, j0, t4, sq, skv, off,
                                causal, scale_log2);
        break;
      default:
        dkv_tile<D, G::kSw, 64>(kt, vt, qt, dot, dk, dv, lse2_s[s],
                                delta_s[s], q0, k0, j0, t4, sq, skv, off,
                                causal, scale_log2);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&q_empty[s]);  // the stage is free
  }

  // epilogue: dk over the K tile, dv over the V tile (every product that
  // read them is done in all four warps), then TMA stores of whole rows,
  // those past Skv dropped
  hopper::named_barrier_sync(1, 128);
  stage_rows<D>(gbase, 0, dk, scale, row_in, t4);
  stage_rows<D>(gbase, G::kTileBytes, dv, 1.f, row_in, t4);
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 128);
  if (threadIdx.x == 0) {
    store_tile<D>(&dk_map, base, k0, h, b);
    store_tile<D>(&dv_map, base + G::kTileBytes, k0, h, b);
    hopper::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kDimsPerThread = 16;

// the sum of `part` over the TPR adjacent lanes that share a row
template <int TPR>
__device__ __forceinline__ float group_sum(float part) {
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, w);
  }
  return part;
}

// K2, f32: one block per (b*h, q tile of blockDim.x / TPR rows); K and V
// tiles of bk keys in dynamic shared memory (2 * bk * D floats).
template <int D>
__global__ void __launch_bounds__(512)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int sq, int skv,
                            float scale, int causal, int bk) {
  constexpr int TPR = D / kDimsPerThread;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + bk * D;

  const int bh = blockIdx.x;
  const int rows = blockDim.x / TPR;
  const int q0 = blockIdx.y * rows;
  const int qi = q0 + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const bool row_valid = qi < sq;
  const int off = skv - sq;
  const int64_t qrow = ((int64_t)bh * sq + qi) * D;
  const int64_t kv_base = (int64_t)bh * skv * D;

  float qr[kDimsPerThread];
  float dor[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    qr[i] = row_valid ? q[qrow + lane + i * TPR] : 0.f;
    dor[i] = row_valid ? dout[qrow + lane + i * TPR] : 0.f;
    acc[i] = 0.f;
  }
  const float row_lse = row_valid ? lse[(int64_t)bh * sq + qi] : kInf;
  const float row_delta = row_valid ? delta[(int64_t)bh * sq + qi] : 0.f;

  const int kv_end = kv_tile_end(q0, rows, sq, skv, off, causal);
  for (int kv0 = 0; kv0 < kv_end; kv0 += bk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < bk * D; idx += blockDim.x) {
      const bool in = kv0 + idx / D < skv;
      ks[idx] = in ? k[kv_base + (int64_t)kv0 * D + idx] : 0.f;
      vs[idx] = in ? v[kv_base + (int64_t)kv0 * D + idx] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < bk; ++jj) {
      const float* kr = ks + jj * D + lane;
      const float* vr = vs + jj * D + lane;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        s = fmaf(qr[i], kr[i * TPR], s);
        dp = fmaf(dor[i], vr[i * TPR], dp);
      }
      s = group_sum<TPR>(s);
      dp = group_sum<TPR>(dp);
      const bool ok = visible(kv0 + jj, qi, sq, skv, off, causal);
      const float p = ok ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dp - row_delta);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        acc[i] = fmaf(ds, kr[i * TPR], acc[i]);
      }
    }
  }
  if (row_valid) {
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      dq[qrow + lane + i * TPR] = acc[i] * scale;
    }
  }
}

// K3, f32: one block per (b*h, kv tile of blockDim.x / TPR keys); Q and dO
// tiles of bq rows, and their lse and delta, in dynamic shared memory
// (2 * bq * D + 2 * bq floats).
template <int D>
__global__ void __launch_bounds__(512)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int sq, int skv, float scale, int causal,
                             int bq) {
  constexpr int TPR = D / kDimsPerThread;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = smem + bq * D;
  float* lse_s = smem + 2 * bq * D;
  float* delta_s = lse_s + bq;

  const int bh = blockIdx.x;
  const int keys = blockDim.x / TPR;
  const int k0 = blockIdx.y * keys;
  const int kj = k0 + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const bool key_valid = kj < skv;
  const int off = skv - sq;
  const int64_t krow = ((int64_t)bh * skv + kj) * D;
  const int64_t q_base = (int64_t)bh * sq * D;

  float kr[kDimsPerThread];
  float vr[kDimsPerThread];
  float dk_acc[kDimsPerThread];
  float dv_acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    kr[i] = key_valid ? k[krow + lane + i * TPR] : 0.f;
    vr[i] = key_valid ? v[krow + lane + i * TPR] : 0.f;
    dk_acc[i] = dv_acc[i] = 0.f;
  }

  for (int q0 = q_tile_begin(k0, bq, off, causal); q0 < sq; q0 += bq) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < bq * D; idx += blockDim.x) {
      const bool in = q0 + idx / D < sq;
      qs[idx] = in ? q[q_base + (int64_t)q0 * D + idx] : 0.f;
      dos[idx] = in ? dout[q_base + (int64_t)q0 * D + idx] : 0.f;
    }
    for (int r = threadIdx.x; r < bq; r += blockDim.x) {
      const bool in = q0 + r < sq;
      lse_s[r] = in ? lse[(int64_t)bh * sq + q0 + r] : kInf;
      delta_s[r] = in ? delta[(int64_t)bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < bq; ++ii) {
      const float* qr = qs + ii * D + lane;
      const float* dor = dos + ii * D + lane;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        s = fmaf(kr[i], qr[i * TPR], s);
        dp = fmaf(vr[i], dor[i * TPR], dp);
      }
      s = group_sum<TPR>(s);
      dp = group_sum<TPR>(dp);
      const bool ok = visible(kj, q0 + ii, sq, skv, off, causal);
      const float p = ok ? expf(s * scale - lse_s[ii]) : 0.f;
      const float ds = p * (dp - delta_s[ii]);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        dv_acc[i] = fmaf(p, dor[i * TPR], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qr[i * TPR], dk_acc[i]);
      }
    }
  }
  if (key_valid) {
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      dk[krow + lane + i * TPR] = dk_acc[i] * scale;
      dv[krow + lane + i * TPR] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kErrO32 = -4;
constexpr int kErrTensorMap = -5;
constexpr int kErrNoStrides = -6;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int batch, heads, sq, skv;
  float scale;
  int causal, block_q, block_k;
  // (b, h, s) strides in elements of q, k, v, dout, then of the outputs
  const int64_t* strides;
  cudaStream_t stream;
  int bh() const { return batch * heads; }
};

// a bf16 (B, H, len, D) tensor with strides `bhs` as a map over (D, len, H,
// B), boxes of a panel's columns and 64 rows
template <int D>
bool bf16_map(CUtensorMap* map, const Args& a, const void* ptr,
              const int64_t* bhs, int len) {
  return hopper::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, D,
                           len, a.heads, a.batch, bhs[2], bhs[1], bhs[0],
                           Bwd<D>::kPanelCols, kTile);
}

// the four inputs' maps, in the order of Args
template <int D>
bool input_maps(CUtensorMap (&maps)[4], const Args& a) {
  return bf16_map<D>(&maps[0], a, a.q, a.strides, a.sq) &&
         bf16_map<D>(&maps[1], a, a.k, a.strides + 3, a.skv) &&
         bf16_map<D>(&maps[2], a, a.v, a.strides + 6, a.skv) &&
         bf16_map<D>(&maps[3], a, a.dout, a.strides + 9, a.sq);
}

// The shared-memory limit of a kernel above 48 KB is a function attribute:
// set once a device.
template <auto Kernel>
int allow_smem(int smem) {
  static std::atomic<uint64_t> set{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (!(set.load() & bit)) {
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set.fetch_or(bit);
  }
  return 0;
}

template <int D>
int launch_dq_bf16(const Args& a, void* dq, const float* o32,
                   float* delta) {
  CUtensorMap in[4];
  CUtensorMap out;
  if (!input_maps<D>(in, a) ||
      !bf16_map<D>(&out, a, dq, a.strides + 12, a.sq)) {
    return kErrTensorMap;
  }
  const int smem = Bwd<D>::kSmemBytes;
  const int err = allow_smem<flash_bwd_dq_wgmma_kernel<D>>(smem);
  if (err) return err;
  const int q_tiles = (a.sq + kTile - 1) / kTile;
  flash_bwd_dq_wgmma_kernel<D>
      <<<dim3(a.bh() * q_tiles), dim3(kThreads), smem, a.stream>>>(
          in[0], in[1], in[2], in[3], out, a.lse, o32, delta, a.heads,
          a.sq, a.skv, a.scale, a.scale * kLog2e, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  CUtensorMap in[4];
  CUtensorMap out[2];
  if (!input_maps<D>(in, a) ||
      !bf16_map<D>(&out[0], a, dk, a.strides + 12, a.skv) ||
      !bf16_map<D>(&out[1], a, dv, a.strides + 15, a.skv)) {
    return kErrTensorMap;
  }
  const int smem = Bwd<D>::kSmemBytes;
  const int err = allow_smem<flash_bwd_dkv_wgmma_kernel<D>>(smem);
  if (err) return err;
  const int kv_tiles = (a.skv + kTile - 1) / kTile;
  flash_bwd_dkv_wgmma_kernel<D>
      <<<dim3(a.bh() * kv_tiles), dim3(kThreads), smem, a.stream>>>(
          in[0], in[1], in[2], in[3], out[0], out[1], a.lse, a.delta,
          a.heads, a.sq, a.skv, a.scale, a.scale * kLog2e, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int D>
int launch_dq_f32(const Args& a, void* dq) {
  constexpr int TPR = D / kDimsPerThread;
  const int smem = 2 * a.block_k * D * static_cast<int>(sizeof(float));
  const int err = set_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(a.bh(), (a.sq + a.block_q - 1) / a.block_q);
  flash_bwd_dq_f32_kernel<D><<<grid, a.block_q * TPR, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.sq, a.skv, a.scale,
      a.causal, a.block_k);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const Args& a, void* dk, void* dv) {
  constexpr int TPR = D / kDimsPerThread;
  const int smem =
      (2 * a.block_q * D + 2 * a.block_q) * static_cast<int>(sizeof(float));
  const int err = set_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(a.bh(), (a.skv + a.block_k - 1) / a.block_k);
  flash_bwd_dkv_f32_kernel<D><<<grid, a.block_k * TPR, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.sq,
      a.skv, a.scale, a.causal, a.block_q);
  return static_cast<int>(cudaGetLastError());
}

// K2 for one head dim: the bf16 body (its own 64-tiles, delta taken from
// o32 and written) or the f32 one (delta read)
template <int D>
int dq_for_dim(const Args& a, int is_bf16, void* dq, const float* o32,
               float* delta) {
  return is_bf16 ? launch_dq_bf16<D>(a, dq, o32, delta)
                 : launch_dq_f32<D>(a, dq);
}

// K3 for one head dim: the bf16 body (its own 64-tiles) or the f32 one
template <int D>
int dkv_for_dim(const Args& a, int is_bf16, void* dk, void* dv) {
  return is_bf16 ? launch_dkv_bf16<D>(a, dk, dv)
                 : launch_dkv_f32<D>(a, dk, dv);
}

// 0, or the negative code of a call the kernels do not take: -3 block_q,
// -2 block_k, -6 bf16 inputs without strides
int check_call(int block_q, int block_k, int is_bf16,
               const int64_t* strides) {
  if (block_q != 16 && block_q != 32 && block_q != 64) return -3;
  if (block_k != 16 && block_k != 32 && block_k != 64) return -2;
  if (is_bf16 && strides == nullptr) return kErrNoStrides;
  return 0;
}

}  // namespace

// q, dout, dq: (batch, heads, sq, dh); k, v: (batch, heads, skv, dh); one
// type, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned; lse and
// delta: contiguous (batch * heads, sq) f32. bf16: o32 is the forward's
// contiguous (batch, heads, sq, dh) f32 output, from which the kernel takes
// delta = rowsum(dout o o32) and writes it into delta, for K3; f32: o32 is
// nullptr and delta is read. bf16 arrays may be strided:
// `strides` holds the (batch, head, row) strides in elements of q, k, v,
// dout and dq (15 values); the last dim is dense and every stride a
// multiple of 16 bytes. f32 arrays are contiguous and `strides` is not
// read. block_q and block_k are the f32 body's tiles (the bf16 body has
// its own: 64 rows, 64 keys). Launches K2 on `stream` and returns 0, the
// launch's cudaError_t, or a negative code: -1 head dim, -2 block_k,
// -3 block_q, -4 o32 missing for bf16 or given for f32, -5 a tensor map
// refused, -6 bf16 inputs without strides.
extern "C" int rafiki_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, void* delta,
                                   const void* o32, void* dq, int batch,
                                   int heads, int sq, int skv, int dh,
                                   float scale, int causal, int is_bf16,
                                   int block_q, int block_k,
                                   const int64_t* strides, void* stream) {
  const int bad = check_call(block_q, block_k, is_bf16, strides);
  if (bad) return bad;
  if ((o32 != nullptr) != (is_bf16 != 0)) return kErrO32;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, heads, sq, skv,
               scale, causal, block_q, block_k, strides,
               static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 16:
      return dq_for_dim<16>(a, is_bf16, dq, static_cast<const float*>(o32),
                             static_cast<float*>(delta));
    case 32:
      return dq_for_dim<32>(a, is_bf16, dq, static_cast<const float*>(o32),
                             static_cast<float*>(delta));
    case 64:
      return dq_for_dim<64>(a, is_bf16, dq, static_cast<const float*>(o32),
                             static_cast<float*>(delta));
    case 128:
      return dq_for_dim<128>(a, is_bf16, dq, static_cast<const float*>(o32),
                             static_cast<float*>(delta));
    default:
      return -1;
  }
}

// As rafiki_flash_bwd_dq, for K3: dk, dv are (batch, heads, skv, dh), and
// `strides` holds those of q, k, v, dout, dk and dv (18 values).
extern "C" int rafiki_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int batch, int heads,
                                    int sq, int skv, int dh, float scale,
                                    int causal, int is_bf16, int block_q,
                                    int block_k, const int64_t* strides,
                                    void* stream) {
  const int bad = check_call(block_q, block_k, is_bf16, strides);
  if (bad) return bad;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, heads, sq, skv,
               scale, causal, block_q, block_k, strides,
               static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 16:
      return dkv_for_dim<16>(a, is_bf16, dk, dv);
    case 32:
      return dkv_for_dim<32>(a, is_bf16, dk, dv);
    case 64:
      return dkv_for_dim<64>(a, is_bf16, dk, dv);
    case 128:
      return dkv_for_dim<128>(a, is_bf16, dk, dv);
    default:
      return -1;
  }
}

extern "C" const char* rafiki_flash_bwd_error(int code) {
  switch (code) {
    case -1:
      return "unsupported head dim";
    case -2:
      return "unsupported block_k";
    case -3:
      return "unsupported block_q";
    case kErrO32:
      return "bf16 K2 takes delta from the forward's f32 output (o32), "
             "f32 K2 reads it";
    case kErrTensorMap:
      return "cuTensorMapEncodeTiled refused a TMA tensor map (base not "
             "16-byte aligned, a stride not a multiple of 16 bytes), or "
             "libcuda has no cuTensorMapEncodeTiled";
    case kErrNoStrides:
      return "bf16 inputs need their strides";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
