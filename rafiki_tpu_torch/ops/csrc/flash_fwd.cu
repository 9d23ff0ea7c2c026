// Forward flash attention for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel rafiki_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward through pl.pallas_call): for q, k, v of
// shape (B*H, S, Dh), o = softmax(q k^T * scale [+ end-aligned causal
// mask]) v by online softmax, with scores, row statistics and the PV sum
// in f32, and without ever writing an (S, S) score tensor to device memory.
//
// Semantics kept from the JAX kernel:
//   - end-aligned causal mask: query i sees key j iff j <= i + (Skv - Sq);
//   - the ragged edge is masked with j < Skv (S = 196 fits no tile);
//   - masked columns get p = 0 explicitly, so a row whose running max is
//     still the -1e30 sentinel does not collect exp(0) = 1 per column;
//   - a row that sees no key (l == 0) writes exactly 0;
//   - kv tiles wholly above the causal band of a q tile are skipped;
//   - with an `lse` pointer (the training forward, JAX's save_lse=True), the
//     row's logsumexp m + log(l) of the scaled scores is stored in f32, +inf
//     for a row that sees no key (so the backward's exp(s - lse) is 0 there).
//     The TPU kernel broadcasts it over 128 lanes because Mosaic needs a
//     lane-wide minor tile; here it is stored compact, one float per row, as
//     (B*H, Sq). The training forward of a bf16 call also writes the f32
//     output (`o32`, the accumulator before the bf16 rounding), from which
//     the backward's delta = rowsum(dO o O) is taken, and takes P V there
//     as two bf16 products, of P rounded and of what the rounding left
//     (hopper::split_bf16), so that o32 is P V to f32's accuracy as the
//     TPU kernel computes it. The backward recomputes P in f32 from the
//     LSE, and a row's dS = P o (dP - delta) sums to 0 only with delta =
//     rowsum(P o dP) of that P: any other delta leaves a per-row error
//     that dQ and dK add up coherently over every key, times the keys'
//     (queries') common component. Where dP - delta is a small difference,
//     as at BERT-base's and ViT-B/16's initialization, that error is most
//     of the gradient: delta from the rounded output moved ViT's q/k
//     projection gradients by 58% of their norm, and delta from an o32 of
//     P rounded to bf16 moved BERT-base's per-layer dQ by up to 14%
//     (scripts/torch_attention_rounding.py, CPU). With lse == o32 ==
//     nullptr (serving) nothing more is written and P V is one product.
//
// Design. On the TPU the kv grid axis runs in order and carries acc/m/l in
// VMEM scratch; Hopper runs blocks in no order, so one CUDA block owns one
// (b*h, q tile) and loops over the kv tiles itself. Two bodies:
//
//   - bf16 (the serving and training path), for every head dim: a block is
//     one producer warp and one consumer warpgroup (64 q rows). The
//     producer loads the Q tile once and the K/V tiles (64 keys) through a
//     ring of kStages shared-memory stages with TMA (cp.async.bulk.tensor,
//     4-d maps over (Dh, S, H, B) with the tensors' own strides, so the
//     projection's (B, H, S, Dh) views are read without a copy; rows past S
//     arrive as zeros), each stage tracked by a full and an empty mbarrier.
//     The consumers run S = Q K^T as wgmma.m64nNk16 with both operands
//     K-major in shared memory, the online softmax in registers (log2
//     units, f32; the mask only on tiles that cross the ragged edge or the
//     causal band), and O += P V as wgmma.m64nDk16 with P from registers
//     (the S accumulators packed to bf16 are already the A operand's
//     layout; the training forward adds the product of P's remainder) and
//     V read as loaded: wgmma takes a 16-bit B MN-major, so V
//     needs no transposing or gathering. A kv tile is N = 64 keys, the last
//     one only its keys rounded up to 16. Tiles are swizzled by TMA over
//     min(2 Dh, 128) bytes (panels of 128-byte rows for Dh = 128), and the
//     descriptors name the same swizzle. The epilogue stages O over the Q
//     tile and the f32 output over the consumed kv stages, swizzled, and
//     writes them with TMA stores, whole rows, the ragged edge dropped by
//     the map. Up to Dh = 64 a serving thread fits 96 registers, so 4
//     blocks share an SM (3 for the training forward). The tile arguments
//     block_q/block_k are the f32 body's; the bf16 body uses its own (64
//     rows, 64 keys), which changes nothing beyond rounding.
//   - f32: scalar FMAs on the CUDA cores (tensor cores would round to
//     TF32), contiguous inputs. TPR = Dh / 16 adjacent threads of a warp own
//     one query row; thread r holds dims r, r + TPR, ... of the scaled q row
//     and of the output accumulator, and a score is 16 FMAs plus log2(TPR)
//     shuffles; K and V tiles are staged by all threads.
//
// Bound. At the ViT-B/16 serving shape (B=64, H=12, S=196, Dh=64, bf16)
// the function must move q, k, v and o once: 77 MB, 23 us at 3.35 TB/s
// (116 MB, 35 us, for the training variant with its f32 output). Its
// 7.6 GFLOP of QK^T and PV take 7.7 us at the bf16 tensor-core peak, so
// the work is bound by bytes. The producer warp keeps the next tile's TMA
// load in flight while the consumers compute, 4 blocks share an SM, the 4
// q tiles of a head run side by side (q tile fastest in the grid) so its
// K/V re-reads hit L2, and no thread spends instructions on addresses or
// fragment gathers. Measured on an H100 (PERF.md): the loads and stores
// alone, with the products and softmax taken out, take 70% of the
// kernel's time and 1.5x its bound; the rest is the consumers' serial
// chain (products, softmax, products) that 4 warpgroups an SM do not fully
// hide. Persistent blocks, clusters sharing a head's K/V by multicast, two
// consumer warpgroups a block and 4 stages were each slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// Whether query `row` sees key `j`: inside the ragged edge and, when
// causal, on or below the end-aligned diagonal (off = Skv - Sq).
__device__ __forceinline__ bool visible(int j, int row, int skv, int off,
                                        int causal) {
  return j < skv && (!causal || j <= row + off);
}

// One past the last key a q tile of `rows` rows from q0 may see: kv tiles
// from there on are skipped.
__device__ __forceinline__ int kv_tile_end(int q0, int rows, int sq, int skv,
                                           int off, int causal) {
  if (!causal) return skv;
  const int q_last = min(q0 + rows, sq) - 1;
  return max(0, min(skv, q_last + off + 1));
}

// logsumexp of a row's scaled scores from its running max and sum; +inf
// when the row saw no key (l == 0)
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // q rows of a block: the M of a wgmma
constexpr int kBlockK = 64;  // keys of a kv tile: the N of S = Q K^T
constexpr int kStages = 2;   // kv tiles in flight
constexpr int kThreads = 160;  // a consumer warpgroup and a producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// logsumexp (natural) of a row from its running max in log2 units and its
// sum; +inf when the row saw no key (l == 0)
__device__ __forceinline__ float row_lse_log2(float m2, float l) {
  return l > 0.f ? m2 * kLn2 + logf(l) : __int_as_float(0x7f800000);
}

// Shared memory of the bf16 body for head dim D, as byte offsets from a
// 1024-byte aligned base (every region a multiple of 1024 bytes): the Q
// tile, then kStages stages of a K and a V tile. Once every tile is
// consumed, the epilogue stages the bf16 output over the Q tile and the
// training variant's f32 output (64 x 4 D bytes) over the stages (2 x 64 x
// 2 D bytes each). A bf16 row of 2 D bytes is swizzled over min(2 D, 128)
// bytes and kept as panels of 128-byte rows when wider; the f32 output
// likewise over min(4 D, 128).
template <int D>
struct Fwd {
  static constexpr int kSw = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kPanelCols = kSw / 2;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kSw32 = 4 * D < 128 ? 4 * D : 128;
  static constexpr int kPanelCols32 = kSw32 / 4;
  static constexpr int kPanels32 = D / kPanelCols32;
  static constexpr int kTileBytes = kBlockQ * 2 * D;  // a Q, K or V tile
  static constexpr int kStage0 = kTileBytes;
  static constexpr int kSmemBytes =
      kStage0 + kStages * 2 * kTileBytes + 1024;  // + alignment slack
  static_assert(kBlockQ == kBlockK, "Q, K and V tiles are the same size");
  static_assert(kBlockQ * 4 * D <= kStages * 2 * kTileBytes, "f32 output");
};

// The online-softmax step of a tile of N keys for this thread's rows r0
// and r0 + 8: S (the accumulator of Q K^T) scaled to log2 units and, where
// kMasked, masked; the running max m and sum l updated and O rescaled; P
// packed to bf16 straight into the A operand of P V (k step kk is S's n
// blocks 2 kk and 2 kk + 1), and where kSplit what that rounding left into
// `pl` (hopper::split_bf16). P is re-masked: zero-filled keys past Skv
// score 0, not -inf, and a row whose max is still the sentinel would get
// exp2(0) = 1.
template <bool kMasked, bool kSplit, int D, int N>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[N / 2], float (&o)[D / 2], float (&m)[2], float (&l)[2],
    uint32_t (&pa)[N / 16][4], uint32_t (&pl)[N / 16][4], int kv0, int r0,
    int t4, int skv, int off, int causal, float scale_log2) {
  float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;  // a row spans the 4 lanes t4
    sc[i] *= scale_log2;
    if (kMasked && !visible(kv0 + (i >> 2) * 8 + 2 * t4 + (i & 1),
                            r0 + 8 * r, skv, off, causal)) {
      sc[i] = kNegInf;
    }
    m_tile[r] = fmaxf(m_tile[r], sc[i]);
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
    const float m_new = fmaxf(m[r], m_tile[r]);
    alpha[r] = hopper::ex2(m[r] - m_new);
    l[r] *= alpha[r];
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i >> 1) & 1;
    float p0 = hopper::ex2(sc[i] - m[r]);
    float p1 = hopper::ex2(sc[i + 1] - m[r]);
    if (kMasked) {
      const int j = kv0 + (i >> 2) * 8 + 2 * t4;
      if (!visible(j, r0 + 8 * r, skv, off, causal)) p0 = 0.f;
      if (!visible(j + 1, r0 + 8 * r, skv, off, causal)) p1 = 0.f;
    }
    l[r] += p0 + p1;
    const int at = ((i >> 2) & 1) * 2 + r;
    if (kSplit) {
      hopper::split_bf16(p0, p1, pa[i >> 3][at], pl[i >> 3][at]);
    } else {
      pa[i >> 3][at] = hopper::pack_bf16(p0, p1);
    }
  }
}

// One kv tile of N keys from kv0 for a consumer warpgroup: S = Q K^T (both
// K-major; a k step of 16 is 32 bytes along a swizzled row, a row wider
// than 128 bytes continues in the next panel), the online softmax, and
// O += P V (V is the MN-major B, read as loaded; where kSplit, P's bf16
// rounding and its remainder in two products). A tile is N = 64 keys,
// or the keys left at the end rounded up to 16, so that the 4 keys past
// 192 at S = 196 cost a 16-wide tile, not a 64-wide one. A tile inside the
// ragged edge and, when causal, wholly on or below the band for every row
// of the tile (the first is row_min) needs no mask.
template <bool kSplit, int D, int Sw, int N>
__device__ __forceinline__ void kv_tile(uint32_t q_rows, uint32_t kt,
                                        uint32_t vt, float (&o)[D / 2],
                                        float (&m)[2], float (&l)[2],
                                        int kv0, int r0, int row_min, int t4,
                                        int skv, int off, int causal,
                                        float scale_log2) {
  float s[N / 2];  // the first k step overwrites it
  uint32_t pa[N / 16][4];
  uint32_t pl[N / 16][4];  // read only where kSplit
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = kk * 32 / Sw;
    const int within = kk * 32 % Sw;
    hopper::wgmma_ss<N>(
        s, hopper::smem_desc<Sw>(q_rows + panel * kBlockQ * Sw + within, 16,
                                 8 * Sw),
        hopper::smem_desc<Sw>(kt + panel * kBlockK * Sw + within, 16, 8 * Sw),
        kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  if (kv0 + N > skv || (causal && kv0 + N - 1 > row_min + off)) {
    softmax_tile<true, kSplit, D, N>(s, o, m, l, pa, pl, kv0, r0, t4, skv,
                                     off, causal, scale_log2);
  } else {
    softmax_tile<false, kSplit, D, N>(s, o, m, l, pa, pl, kv0, r0, t4, skv,
                                      off, causal, scale_log2);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t vd = hopper::smem_desc<Sw>(vt + kk * 16 * Sw,
                                              kBlockK * Sw, 8 * Sw);
    hopper::wgmma_rs<D>(o, pa[kk], vd);
    if (kSplit) hopper::wgmma_rs<D>(o, pl[kk], vd);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
}

// One block per (b*h, q tile of 64 rows); grid.x = B*H * q tiles, q tile
// fastest, so the tiles of one head run side by side and share its K/V in
// L2. Warps 0-3 are the consumer warpgroup, warp 4 the producer. Maps are
// 4-d over (Dh, S, H, B) with the tensors' own strides. kTrain: the
// training forward, which writes the LSE and the f32 output and takes P V
// as two products (P's remainder's registers cost it a block an SM). Up to
// Dh = 64 the serving consumers fit 96 registers a thread and 4 blocks
// share an SM; Dh = 128 needs more (its O alone is 64).
template <int D, bool kTrain>
__global__ void __launch_bounds__(kThreads, D <= 64 ? (kTrain ? 3 : 4) : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap o_map,
                           const __grid_constant__ CUtensorMap o32_map,
                           float* __restrict__ lse, int heads, int sq,
                           int skv, float scale_log2, int causal) {
  using G = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t kv_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);

  const int q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const int off = skv - sq;  // end-aligned causal offset
  // one past the last key any row of the block sees
  const int kv_end = kv_tile_end(q0, kBlockQ, sq, skv, off, causal);
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

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
    // producer: the Q tile once, then the kv tiles through the ring; rows
    // past S arrive as zeros and count in the expected bytes
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&q_full, G::kTileBytes);
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::tma_load_4d(base + p * kBlockQ * G::kSw, &q_map, &q_full,
                            p * G::kPanelCols, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) {
          hopper::mbar_wait(&kv_empty[s], (t / kStages - 1) & 1);
        }
        hopper::mbar_arrive_expect_tx(&kv_full[s], 2 * G::kTileBytes);
        const uint32_t kt = base + G::kStage0 + s * 2 * G::kTileBytes;
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_4d(kt + p * kBlockK * G::kSw, &k_map, &kv_full[s],
                              p * G::kPanelCols, t * kBlockK, h, b);
          hopper::tma_load_4d(kt + G::kTileBytes + p * kBlockK * G::kSw,
                              &v_map, &kv_full[s], p * G::kPanelCols,
                              t * kBlockK, h, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are row_in and row_in + 8
  // of the tile
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row_in = 16 * warp + g;
  const int r0 = q0 + row_in;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the scaled scores, log2
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  hopper::mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&kv_full[s], (t / kStages) & 1);
    const uint32_t kt = base + G::kStage0 + s * 2 * G::kTileBytes;
    const uint32_t vt = kt + G::kTileBytes;
    const int kv0 = t * kBlockK;
    switch (min(kBlockK, kv_end - kv0 + 15) / 16) {
      case 1:
        kv_tile<kTrain, D, G::kSw, 16>(base, kt, vt, o, m, l, kv0, r0, q0,
                                       t4, skv, off, causal, scale_log2);
        break;
      case 2:
        kv_tile<kTrain, D, G::kSw, 32>(base, kt, vt, o, m, l, kv0, r0, q0,
                                       t4, skv, off, causal, scale_log2);
        break;
      case 3:
        kv_tile<kTrain, D, G::kSw, 48>(base, kt, vt, o, m, l, kv0, r0, q0,
                                       t4, skv, off, causal, scale_log2);
        break;
      default:
        kv_tile<kTrain, D, G::kSw, 64>(base, kt, vt, o, m, l, kv0, r0, q0,
                                       t4, skv, off, causal, scale_log2);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&kv_empty[s]);  // the stage is free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (kTrain && t4 == 0 && row < sq) {
      lse[(int64_t)bh * sq + row] = row_lse_log2(m[r], l[r]);
    }
    l[r] = 1.f / fmaxf(l[r], 1e-30f);  // l == 0 -> o == 0 -> out 0
  }

  // epilogue: the normalised rows into shared memory (bf16 over the Q
  // tile, f32 over the kv stages: every tile has been consumed), swizzled
  // as the TMA stores read them; the stores write whole rows and drop
  // those past Sq
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row_in + 8 * r;
      const float x0 = o[4 * j + 2 * r] * l[r];
      const float x1 = o[4 * j + 2 * r + 1] * l[r];
      const uint32_t at = (c * 2 / G::kSw) * kBlockQ * G::kSw + rr * G::kSw +
                          c * 2 % G::kSw;
      *reinterpret_cast<uint32_t*>(gbase + hopper::swizzle<G::kSw>(at)) =
          hopper::pack_bf16(x0, x1);
      if (kTrain) {
        const uint32_t at32 = G::kStage0 +
                              (c * 4 / G::kSw32) * kBlockQ * G::kSw32 +
                              rr * G::kSw32 + c * 4 % G::kSw32;
        *reinterpret_cast<float2*>(gbase +
                                   hopper::swizzle<G::kSw32>(at32)) =
            make_float2(x0, x1);
      }
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 128);  // the consumer warpgroup
  if (threadIdx.x == 0) {
    for (int p = 0; p < G::kPanels; ++p) {
      hopper::tma_store_4d(&o_map, base + p * kBlockQ * G::kSw,
                           p * G::kPanelCols, q0, h, b);
    }
    if (kTrain) {
      for (int p = 0; p < G::kPanels32; ++p) {
        hopper::tma_store_4d(&o32_map,
                             base + G::kStage0 + p * kBlockQ * G::kSw32,
                             p * G::kPanelCols32, q0, h, b);
      }
    }
    hopper::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kDimsPerThread = 16;

// One block per (b*h, q tile of blockDim.x / TPR rows); K and V tiles in
// dynamic shared memory, 2 * BK * D floats.
template <int D, int BK>
__global__ void __launch_bounds__(512)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int sq, int skv,
                         float scale, int causal) {
  constexpr int TPR = D / kDimsPerThread;  // threads per query row
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + BK * D;

  const int bh = blockIdx.x;
  const int rows = blockDim.x / TPR;
  const int q0 = blockIdx.y * rows;
  const int qi = q0 + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const bool row_valid = qi < sq;
  const int off = skv - sq;  // end-aligned causal offset

  const int64_t q_base = (int64_t)bh * sq * D;
  const int64_t kv_base = (int64_t)bh * skv * D;

  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    qr[i] = row_valid ? q[q_base + (int64_t)qi * D + lane + i * TPR] * scale
                      : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int kv_end = kv_tile_end(q0, rows, sq, skv, off, causal);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * D; idx += blockDim.x) {
      const int j = kv0 + idx / D;
      const bool in = j < skv;
      ks[idx] = in ? k[kv_base + (int64_t)kv0 * D + idx] : 0.f;
      vs[idx] = in ? v[kv_base + (int64_t)kv0 * D + idx] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = kNegInf;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        part = fmaf(qr[i], ks[jj * D + lane + i * TPR], part);
      }
#pragma unroll
      for (int w = TPR / 2; w > 0; w >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, w);
      }
      const int j = kv0 + jj;
      const bool ok = visible(j, qi, skv, off, causal);
      s[jj] = ok ? part : kNegInf;
      m_tile = fmaxf(m_tile, s[jj]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const int j = kv0 + jj;
      const bool ok = visible(j, qi, skv, off, causal);
      const float p = ok ? expf(s[jj] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        acc[i] = fmaf(p, vs[jj * D + lane + i * TPR], acc[i]);
      }
    }
    m = m_new;
  }

  if (row_valid && lse != nullptr && lane == 0) {
    lse[(int64_t)bh * sq + qi] = row_lse(m, l);
  }
  if (row_valid) {
    const float denom = fmaxf(l, 1e-30f);  // l == 0 -> acc == 0 -> out 0
    float* out = o + q_base + (int64_t)qi * D;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      out[lane + i * TPR] = acc[i] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kErrTensorMap = -5;
constexpr int kErrNoStrides = -6;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: no LSE output
  float* o32;  // nullptr: no f32 output (bf16 only)
  int batch, heads, sq, skv;
  float scale;
  int causal, block_q;
  const int64_t* strides;  // (b, h, s) of q, k, v, o, in elements
  cudaStream_t stream;
  int bh() const { return batch * heads; }
};

// the bf16 body's launch for the serving (kTrain false) or the training
// forward, through the maps of q, k, v, o and o32
template <int D, bool kTrain>
int launch_wgmma(const Args& a, const CUtensorMap (&maps)[5]) {
  const int smem = Fwd<D>::kSmemBytes;
  // the shared-memory limit is a function attribute: set once a device
  static std::atomic<uint64_t> limit_set{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (!(limit_set.load() & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kTrain>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set.fetch_or(bit);
  }
  const int q_tiles = (a.sq + kBlockQ - 1) / kBlockQ;
  flash_fwd_wgmma_kernel<D, kTrain>
      <<<dim3(a.bh() * q_tiles), dim3(kThreads), smem, a.stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], a.lse, a.heads, a.sq,
          a.skv, a.scale * kLog2e, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a) {
  using G = Fwd<D>;
  // a bf16 (B, H, S, D) tensor with strides (b, h, s) as a map over
  // (D, S, H, B), boxes of a panel's columns and `rows` rows
  const auto bf16_map = [&](CUtensorMap* map, const void* ptr,
                            const int64_t* bhs, int len, int rows) {
    return hopper::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, D,
                             len, a.heads, a.batch, bhs[2], bhs[1], bhs[0],
                             G::kPanelCols, rows);
  };
  CUtensorMap maps[5];
  bool ok = bf16_map(&maps[0], a.q, a.strides, a.sq, kBlockQ) &&
            bf16_map(&maps[1], a.k, a.strides + 3, a.skv, kBlockK) &&
            bf16_map(&maps[2], a.v, a.strides + 6, a.skv, kBlockK) &&
            bf16_map(&maps[3], a.o, a.strides + 9, a.sq, kBlockQ);
  if (a.o32 != nullptr) {  // contiguous (B, H, S, D) f32
    ok = ok && hopper::encode_4d(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                 a.o32, D, a.sq, a.heads, a.batch, D,
                                 (int64_t)a.sq * D,
                                 (int64_t)a.heads * a.sq * D,
                                 G::kPanelCols32, kBlockQ);
  } else {
    maps[4] = maps[3];  // not read
  }
  if (!ok) return kErrTensorMap;
  return a.o32 != nullptr ? launch_wgmma<D, true>(a, maps)
                          : launch_wgmma<D, false>(a, maps);
}

template <int D, int BK>
int launch_f32(const Args& a) {
  constexpr int TPR = D / kDimsPerThread;
  const int smem = 2 * BK * D * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.bh(), (a.sq + a.block_q - 1) / a.block_q);
  const dim3 block(a.block_q * TPR);
  flash_fwd_f32_kernel<D, BK><<<grid, block, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.sq,
      a.skv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// one consumer warpgroup of 64 q rows a block: at S = 196 that is 4 blocks
// a head, 3,072 at B = 64 and 384 at B = 8 (132 SMs)
int dispatch_bf16(const Args& a, int dh) {
  switch (dh) {
    case 16:
      return launch_bf16<16>(a);
    case 32:
      return launch_bf16<32>(a);
    case 64:
      return launch_bf16<64>(a);
    case 128:
      return launch_bf16<128>(a);
    default:
      return -1;
  }
}

template <int BK>
int dispatch_f32(const Args& a, int dh) {
  switch (dh) {
    case 16:
      return launch_f32<16, BK>(a);
    case 32:
      return launch_f32<32, BK>(a);
    case 64:
      return launch_f32<64, BK>(a);
    case 128:
      return launch_f32<128, BK>(a);
    default:
      return -1;
  }
}

}  // namespace

// q, k, v, o: (batch, heads, sq|skv, dh) device arrays of one type, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1). bf16 arrays may be strided views:
// `strides` holds the (batch, head, row) strides in elements of q, k, v
// and o (12 values); the last dim is dense, every stride a multiple of 16
// bytes and every base 16-byte aligned. f32 arrays are contiguous and
// `strides` is not read. lse: nullptr, or a contiguous (batch * heads, sq)
// f32 array that receives each row's logsumexp; o32: nullptr, or (bf16
// only, and then given with lse) a contiguous (batch, heads, sq, dh) f32
// array that receives the output before its rounding. block_q and block_k
// are the f32 body's tiles (the bf16 body has its own: 64 q rows, 64 keys).
// Launches on `stream` and returns 0, the launch's cudaError_t, or a
// negative code: -1 head dim, -2 block_k, -3 block_q, -4 o32 with f32
// inputs, or with bf16 inputs one of lse and o32 without the other, -5 a
// tensor map refused, -6 bf16 inputs without strides.
extern "C" int rafiki_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, void* o32, int batch,
                                int heads, int sq, int skv, int dh,
                                float scale, int causal, int is_bf16,
                                int block_q, int block_k,
                                const int64_t* strides, void* stream) {
  if (block_q != 16 && block_q != 32 && block_q != 64) return -3;
  if (block_k != 16 && block_k != 32 && block_k != 64) return -2;
  // bf16: the training forward writes both, serving neither
  if (is_bf16 ? (o32 != nullptr) != (lse != nullptr) : o32 != nullptr) {
    return -4;
  }
  if (is_bf16 && strides == nullptr) return kErrNoStrides;
  const Args a{q, k, v, o, static_cast<float*>(lse), static_cast<float*>(o32),
               batch, heads, sq, skv, scale, causal, block_q, strides,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) return dispatch_bf16(a, dh);
  switch (block_k) {
    case 16:
      return dispatch_f32<16>(a, dh);
    case 32:
      return dispatch_f32<32>(a, dh);
    default:
      return dispatch_f32<64>(a, dh);
  }
}

extern "C" const char* rafiki_flash_error(int code) {
  switch (code) {
    case -1:
      return "unsupported head dim";
    case -2:
      return "unsupported block_k";
    case -3:
      return "unsupported block_q";
    case -4:
      return "an f32 output copy is for bf16 inputs only, and bf16 inputs "
             "take it with the LSE";
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
