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
// delta = rowsum(dO o O) in f32, which the wrapper computes in PyTorch as
// the JAX package computes it outside Pallas. Scores, P and dS never leave
// the SM; dq, dk and dv are accumulated in f32 and written once in the
// input type.
//
// Semantics kept from the JAX kernels:
//   - end-aligned causal mask: query i sees key j iff j <= i + (Skv - Sq);
//   - no padded copies: the TPU zero-pads q, k, v, dO and O to the tile and
//     relies on zero rows contributing 0. Here the ragged edges are masked
//     in the kernels: key columns >= Skv and query rows >= Sq get P = 0
//     explicitly, staged tiles are zero-filled past the end, nothing is read
//     or written out of bounds;
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
//   - K2: one block per (b*h, q tile). Each warp owns 16 query rows and keeps
//     their Q and dO as mma A fragments in registers for the whole loop; for
//     each kv tile (K and V staged in shared memory) it computes S = Q K^T
//     and dP = dO V^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//     forms P and dS = P o (dP - delta) in registers, and adds dS K to its
//     dq accumulator. The S/dP accumulators have the register layout of the
//     next product's A operand, so dS goes to it without shared memory.
//   - K3: one block per (b*h, kv tile). Each warp owns 16 keys and keeps K
//     and V as A fragments. The transposed products dV = P^T dO and
//     dK = dS^T Q need P^T and dS^T as A operands, so K3 computes the
//     transposed scores S^T = K Q^T and dP^T = V dO^T directly (the staged
//     Q and dO tiles are then the B operands): P^T and dS^T land in the
//     accumulator layout and go to the A fragments of the next products in
//     registers, as in K2. The per-query lse and delta (now per column) are
//     staged in shared memory beside the Q and dO tiles.
//   - f32: scalar FMAs on the CUDA cores, as in flash_fwd.cu (the tensor
//     cores would round to TF32). D / 16 adjacent threads of a warp own one
//     query row (K2) or one key (K3), 16 dimensions each; dot products are
//     16 FMAs and log2(D / 16) shuffles. Tiles are runtime sizes here.
//
// Bound. At the ViT-B/16 training shape (B*H = 768, S = 196, Dh = 64, bf16)
// K2 must read q, k, v, dO, lse and delta and write dq (97.5 MB; 29 us at
// 3.35 TB/s) and K3 the same inputs and dk, dv (116.8 MB; 35 us); their
// 11.3 and 15.1 GFLOP take 11 and 15 us at the bf16 tensor-core peak, so
// both are memory-bound. Each q (kv) tile re-reads the K/V (Q/dO) tiles of
// its head, which hit L2. What this version leaves on the table: tiles are
// loaded synchronously (no cp.async/TMA double buffering), B fragments are
// read with 32- and 16-bit shared loads rather than ldmatrix, the 16-bit
// gathers of the transposed B operands (K in K2; Q and dO in K3) cost
// two shared loads per register, and at S = 196 the 64-wide tiles are 77%
// used. wgmma fed by TMA is the step after this one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from different rows (the low half holds the first)
__device__ __forceinline__ uint32_t gather_pair(const __nv_bfloat16* lo,
                                                const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi))
          << 16);
}

// The A fragments (m16n8k16 layout; lane = 4 * g + t) of 16 rows of a
// row-major (rows, D) array from row r0 - g: rows r0 and r0 + 8, zero
// past `n` rows.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* base,
                                            int r0, int n, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool lo = r0 < n;
    const bool hi = r0 + 8 < n;
    f[kk][0] = lo ? load_pair(base + (int64_t)r0 * D + c) : 0u;
    f[kk][1] = hi ? load_pair(base + (int64_t)(r0 + 8) * D + c) : 0u;
    f[kk][2] = lo ? load_pair(base + (int64_t)r0 * D + c + 8) : 0u;
    f[kk][3] = hi ? load_pair(base + (int64_t)(r0 + 8) * D + c + 8) : 0u;
  }
}

// Stage rows r0 .. r0 + rows - 1 of two row-major (n, D) arrays into shared
// tiles with row stride LD, 16 bytes per thread, zero past row n.
template <int D, int LD>
__device__ __forceinline__ void stage_tiles(__nv_bfloat16* as,
                                            __nv_bfloat16* bs,
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* b, int r0,
                                            int rows, int n) {
  for (int idx = threadIdx.x; idx < rows * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    const int row = r0 + r;
    uint4 ax = make_uint4(0, 0, 0, 0);
    uint4 bx = make_uint4(0, 0, 0, 0);
    if (row < n) {
      ax = *reinterpret_cast<const uint4*>(a + (int64_t)row * D + c);
      bx = *reinterpret_cast<const uint4*>(b + (int64_t)row * D + c);
    }
    *reinterpret_cast<uint4*>(as + r * LD + c) = ax;
    *reinterpret_cast<uint4*>(bs + r * LD + c) = bx;
  }
}

// acc[16 x n] += A B over k = 16 * KS, where A is given as fragments and
// B[k][n] = tile[k][n] of a shared tile with row stride LD (B is the tile
// itself, not its transpose: the two halves of a B register come from two
// rows, gathered with 16-bit loads).
template <int KS, int DT, int LD>
__device__ __forceinline__ void mma_a_tile(float (&acc)[DT][4],
                                           const uint32_t (&a)[KS][4],
                                           const __nv_bfloat16* tile, int g,
                                           int t) {
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const __nv_bfloat16* col = tile + (2 * t) * LD + dt * 8 + g;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const __nv_bfloat16* b = col + kk * 16 * LD;
      mma_bf16_16816(acc[dt], a[kk], gather_pair(b, b + LD),
                     gather_pair(b + 8 * LD, b + 9 * LD));
    }
  }
}

// s[16 x 8 NT] = A T^T, where A is given as fragments over k = D and T is a
// shared tile of 8 NT rows with row stride LD (the B register halves are
// adjacent elements of one row of T).
template <int KD, int NT, int LD>
__device__ __forceinline__ void mma_a_tile_t(float (&s)[NT][4],
                                             const uint32_t (&a)[KD][4],
                                             const __nv_bfloat16* tile, int g,
                                             int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* row = tile + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      mma_bf16_16816(s[nt], a[kk], load_pair(row + kk * 16),
                     load_pair(row + kk * 16 + 8));
    }
  }
}

// K2: one block per (b*h, q tile of 16 * warps rows), looping over kv tiles
// of BK keys.
template <int D, int BK>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int sq, int skv,
                             float scale, int causal) {
  constexpr int LD = D + 8;  // padded shared row: conflict-free fragments
  constexpr int KD = D / 16;
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int bh = blockIdx.x;
  const int rows = (blockDim.x / 32) * 16;
  const int q0 = blockIdx.y * rows;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const int off = skv - sq;

  const int64_t qoff = (int64_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (int64_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (int64_t)bh * skv * D;

  uint32_t qf[KD][4];
  uint32_t dof[KD][4];
  load_a_rows<D>(qf, q + qoff, r0, sq, t);
  load_a_rows<D>(dof, dout + qoff, r0, sq, t);
  float row_lse[2];
  float row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    row_lse[i] = row < sq ? lse[(int64_t)bh * sq + row] : kInf;
    row_delta[i] = row < sq ? delta[(int64_t)bh * sq + row] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int kv_end = kv_tile_end(q0, rows, sq, skv, off, causal);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tiles<D, LD>(ks, vs, kb, vb, kv0, BK, skv);
    __syncthreads();

    float s[NT][4];
    float dp[NT][4];
    mma_a_tile_t<KD, NT, LD>(s, qf, ks, g, t);   // S = Q K^T
    mma_a_tile_t<KD, NT, LD>(dp, dof, vs, g, t);  // dP = dO V^T

    // dS = P o (dP - delta), straight into the A fragments of dS K
    uint32_t dsf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int j = kv0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = visible(j, r0 + i * 8, sq, skv, off, causal);
        const float p = ok ? __expf(s[nt][e] * scale - row_lse[i]) : 0.f;
        ds[e] = p * (dp[nt][e] - row_delta[i]);
      }
      dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_a_tile<NT / 2, DT, LD>(acc, dsf, ks, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < sq) {
      *reinterpret_cast<uint32_t*>(dq + qoff + (int64_t)r0 * D + c) =
          pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (r0 + 8 < sq) {
      *reinterpret_cast<uint32_t*>(dq + qoff + (int64_t)(r0 + 8) * D + c) =
          pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

// K3: one block per (b*h, kv tile of 16 * warps keys), looping over q tiles
// of BQ rows. Works on the transposed problem: S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q.
template <int D, int BQ>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int sq, int skv,
                              float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int NT = BQ / 8;  // n tiles of S^T: queries
  constexpr int DT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[BQ * LD];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int bh = blockIdx.x;
  const int keys = (blockDim.x / 32) * 16;
  const int k0 = blockIdx.y * keys;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int j0 = k0 + warp * 16 + g;  // this thread's keys: j0, j0 + 8
  const int off = skv - sq;

  const int64_t kvoff = (int64_t)bh * skv * D;
  const __nv_bfloat16* qb = q + (int64_t)bh * sq * D;
  const __nv_bfloat16* dob = dout + (int64_t)bh * sq * D;

  uint32_t kf[KD][4];
  uint32_t vf[KD][4];
  load_a_rows<D>(kf, k + kvoff, j0, skv, t);
  load_a_rows<D>(vf, v + kvoff, j0, skv, t);
  float dk_acc[DT][4];
  float dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  for (int q0 = q_tile_begin(k0, BQ, off, causal); q0 < sq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tiles<D, LD>(qs, dos, qb, dob, q0, BQ, sq);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const int row = q0 + r;
      lse_s[r] = row < sq ? lse[(int64_t)bh * sq + row] : kInf;
      delta_s[r] = row < sq ? delta[(int64_t)bh * sq + row] : 0.f;
    }
    __syncthreads();

    float s[NT][4];
    float dp[NT][4];
    mma_a_tile_t<KD, NT, LD>(s, kf, qs, g, t);    // S^T = K Q^T
    mma_a_tile_t<KD, NT, LD>(dp, vf, dos, g, t);  // dP^T = V dO^T

    // P^T and dS^T (rows: keys, columns: queries), into A fragments
    uint32_t pf[NT / 2][4];
    uint32_t dsf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + (e >> 1) * 8;
        const int col = nt * 8 + 2 * t + (e & 1);
        const bool ok = visible(j, q0 + col, sq, skv, off, causal);
        p[e] = ok ? __expf(s[nt][e] * scale - lse_s[col]) : 0.f;
        ds[e] = p[e] * (dp[nt][e] - delta_s[col]);
      }
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_a_tile<NT / 2, DT, LD>(dv_acc, pf, dos, g, t);  // dV += P^T dO
    mma_a_tile<NT / 2, DT, LD>(dk_acc, dsf, qs, g, t);  // dK += dS^T Q
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (j0 < skv) {
      const int64_t at = kvoff + (int64_t)j0 * D + c;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (j0 + 8 < skv) {
      const int64_t at = kvoff + (int64_t)(j0 + 8) * D + c;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int bh, sq, skv;
  float scale;
  int causal, block_q, block_k;
  cudaStream_t stream;
};

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int D, int BK>
int launch_dq_bf16(const Args& a, void* dq) {
  const dim3 grid(a.bh, (a.sq + a.block_q - 1) / a.block_q);
  flash_bwd_dq_bf16_kernel<D, BK><<<grid, a.block_q * 2, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.sq, a.skv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ>
int launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  const dim3 grid(a.bh, (a.skv + a.block_k - 1) / a.block_k);
  flash_bwd_dkv_bf16_kernel<D, BQ><<<grid, a.block_k * 2, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.sq,
      a.skv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_f32(const Args& a, void* dq) {
  constexpr int TPR = D / kDimsPerThread;
  const int smem = 2 * a.block_k * D * static_cast<int>(sizeof(float));
  const int err = set_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(a.bh, (a.sq + a.block_q - 1) / a.block_q);
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
  const dim3 grid(a.bh, (a.skv + a.block_k - 1) / a.block_k);
  flash_bwd_dkv_f32_kernel<D><<<grid, a.block_k * TPR, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.sq,
      a.skv, a.scale, a.causal, a.block_q);
  return static_cast<int>(cudaGetLastError());
}

// K2 for one head dim: the bf16 instantiation for block_k, or the f32 one
template <int D>
int dq_for_dim(const Args& a, int is_bf16, void* dq) {
  if (!is_bf16) return launch_dq_f32<D>(a, dq);
  switch (a.block_k) {
    case 16:
      return launch_dq_bf16<D, 16>(a, dq);
    case 32:
      return launch_dq_bf16<D, 32>(a, dq);
    default:
      return launch_dq_bf16<D, 64>(a, dq);
  }
}

// K3 for one head dim: the bf16 instantiation for block_q, or the f32 one
template <int D>
int dkv_for_dim(const Args& a, int is_bf16, void* dk, void* dv) {
  if (!is_bf16) return launch_dkv_f32<D>(a, dk, dv);
  switch (a.block_q) {
    case 16:
      return launch_dkv_bf16<D, 16>(a, dk, dv);
    case 32:
      return launch_dkv_bf16<D, 32>(a, dk, dv);
    default:
      return launch_dkv_bf16<D, 64>(a, dk, dv);
  }
}

// 0, or the negative code of an unsupported tile: -3 block_q, -2 block_k
int check_tiles(int block_q, int block_k) {
  if (block_q != 16 && block_q != 32 && block_q != 64) return -3;
  if (block_k != 16 && block_k != 32 && block_k != 64) return -2;
  return 0;
}

}  // namespace

// q, dout, dq: contiguous (bh, sq, dh); k, v: contiguous (bh, skv, dh); one
// type, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned; lse and
// delta: contiguous (bh, sq) f32. Launches K2 on `stream` and returns 0, the
// launch's cudaError_t, or a negative code: -1 head dim, -2 block_k,
// -3 block_q.
extern "C" int rafiki_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int sq, int skv, int dh,
                                   float scale, int causal, int is_bf16,
                                   int block_q, int block_k, void* stream) {
  const int bad = check_tiles(block_q, block_k);
  if (bad) return bad;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, sq, skv, scale, causal,
               block_q, block_k, static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 16:
      return dq_for_dim<16>(a, is_bf16, dq);
    case 32:
      return dq_for_dim<32>(a, is_bf16, dq);
    case 64:
      return dq_for_dim<64>(a, is_bf16, dq);
    case 128:
      return dq_for_dim<128>(a, is_bf16, dq);
    default:
      return -1;
  }
}

// As rafiki_flash_bwd_dq, for K3: dk, dv are contiguous (bh, skv, dh).
extern "C" int rafiki_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int sq,
                                    int skv, int dh, float scale, int causal,
                                    int is_bf16, int block_q, int block_k,
                                    void* stream) {
  const int bad = check_tiles(block_q, block_k);
  if (bad) return bad;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, sq, skv, scale, causal,
               block_q, block_k, static_cast<cudaStream_t>(stream)};
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
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
