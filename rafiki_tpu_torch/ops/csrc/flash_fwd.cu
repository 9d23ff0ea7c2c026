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
//     the backward's delta = rowsum(dO o O) is taken: delta from the
//     rounded output carries a per-row error that the backward adds up
//     coherently over every key, and at ViT-B/16's initialization, where
//     dP - delta is a small difference, it moved the q/k projection
//     gradients by 58% of their norm (CPU measurement against an f32 run;
//     5% with this output). With lse == o32 == nullptr (serving) nothing
//     more is written.
//
// Design. On the TPU the kv grid axis runs in order and carries acc/m/l in
// VMEM scratch; Hopper runs blocks in no order, so one CUDA block owns one
// (b*h, q tile) and loops over the kv tiles itself, staging each K and V
// tile in shared memory. Two bodies share that structure:
//
//   - bf16 (the serving path): each warp owns 16 query rows and computes
//     S = Q K^T and O += P V with tensor-core mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate). Q stays in registers as A fragments for the whole
//     kv loop; P goes from the S accumulators straight into the A
//     fragments of the PV product without touching shared memory. Rows of
//     the K/V tiles are padded by 8 elements so the fragment reads hit 32
//     distinct banks.
//   - f32: scalar FMAs on the CUDA cores (tensor cores would round to
//     TF32). TPR = Dh / 16 adjacent threads of a warp own one query row;
//     thread r holds dims r, r + TPR, ... of the scaled q row and of the
//     output accumulator, and a score is 16 FMAs plus log2(TPR) shuffles.
//
// Bound. At the ViT-B/16 serving shape (B=64, H=12, S=196, Dh=64, bf16)
// the function must move q, k, v and o once: 77 MB, 23 us at 3.35 TB/s.
// Its 7.6 GFLOP of QK^T and PV take 7.7 us at the bf16 tensor-core peak,
// so the work is memory-bound. Scores never leave the SM, and the K/V
// re-reads by the 4 q tiles of a head hit L2, so device-memory traffic
// stays near the 77 MB. What this version leaves on the table: tiles are
// loaded synchronously (no cp.async/TMA double buffering, so a block waits
// on each load), the B fragments are read with 32- and 16-bit shared loads
// rather than ldmatrix, and at S = 196 a 64-row q tile and a 64-key kv
// tile are 77% used. wgmma fed by TMA, with a producer warp, is the step
// after this one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// One block per (b*h, q tile of 16 * warps rows); warp w owns rows
// 16w .. 16w + 15 of the tile. Fragment layouts are those of PTX's
// mma.m16n8k16: lane = 4 * g + t; A and C hold rows g and g + 8, C holds
// columns 2t and 2t + 1 of each 8-wide n tile.
template <int D, int BK>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, float* __restrict__ o32,
                          int sq, int skv, float scale, int causal) {
  constexpr int LD = D + 8;  // padded shared row: conflict-free fragments
  constexpr int KD = D / 16;  // k steps of Q K^T
  constexpr int NT = BK / 8;  // n tiles of S
  constexpr int DT = D / 8;  // n tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int bh = blockIdx.x;
  const int rows = (blockDim.x / 32) * 16;
  const int q0 = blockIdx.y * rows;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const int off = skv - sq;  // end-aligned causal offset

  const __nv_bfloat16* qb = q + (int64_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (int64_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (int64_t)bh * skv * D;

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < sq ? load_pair(qb + (int64_t)r0 * D + c) : 0u;
    qf[kk][1] = r0 + 8 < sq ? load_pair(qb + (int64_t)(r0 + 8) * D + c) : 0u;
    qf[kk][2] = r0 < sq ? load_pair(qb + (int64_t)r0 * D + c + 8) : 0u;
    qf[kk][3] =
        r0 + 8 < sq ? load_pair(qb + (int64_t)(r0 + 8) * D + c + 8) : 0u;
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int kv_end = kv_tile_end(q0, rows, sq, skv, off, causal);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    // 16-byte loads; keys past Skv are zero (V = 0 keeps 0 * p finite)
    for (int idx = threadIdx.x; idx < BK * (D / 8); idx += blockDim.x) {
      const int r = idx / (D / 8);
      const int c = (idx % (D / 8)) * 8;
      const int j = kv0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0);
      uint4 vx = make_uint4(0, 0, 0, 0);
      if (j < skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (int64_t)j * D + c);
        vx = *reinterpret_cast<const uint4*>(vb + (int64_t)j * D + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vx;
    }
    __syncthreads();

    // S = Q K^T over this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma_bf16_16816(s[nt], qf[kk], load_pair(krow + kk * 16),
                       load_pair(krow + kk * 16 + 8));
      }
    }

    // scale, mask, and the tile's row maxima (a row spans the 4 lanes t)
    float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int j = kv0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = visible(j, row, skv, off, causal);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 1));
      m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 2));
      m_new[i] = fmaxf(m[i], m_tile[i]);
      alpha[i] = __expf(m[i] - m_new[i]);
      l[i] *= alpha[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // P, re-masked, straight into the A fragments of P V: n tiles 2kk and
    // 2kk + 1 of S are columns 0-7 and 8-15 of k step kk
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int j = kv0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = visible(j, row, skv, off, causal);
        p[e] = ok ? __expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        l[e >> 1] += p[e];
      }
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const __nv_bfloat16* vcol = vs + (2 * t) * LD + dt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const __nv_bfloat16* vk = vcol + kk * 16 * LD;
        mma_bf16_16816(acc[dt], pf[kk], gather_pair(vk, vk + LD),
                       gather_pair(vk + 8 * LD, vk + 9 * LD));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + i * 8;
    if (lse != nullptr && t == 0 && row < sq) {
      lse[(int64_t)bh * sq + row] = row_lse(m[i], l[i]);
    }
    l[i] = fmaxf(l[i], 1e-30f);  // l == 0 -> acc == 0 -> out 0
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + i * 8;
      if (row >= sq) continue;
      const float2 out = make_float2(acc[dt][2 * i] / l[i],
                                     acc[dt][2 * i + 1] / l[i]);
      const int64_t at = ((int64_t)bh * sq + row) * D + c;
      *reinterpret_cast<uint32_t*>(o + at) = pack_bf16(out.x, out.y);
      if (o32 != nullptr) *reinterpret_cast<float2*>(o32 + at) = out;
    }
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: no LSE output
  float* o32;  // nullptr: no f32 output (bf16 only)
  int bh, sq, skv;
  float scale;
  int causal, block_q;
  cudaStream_t stream;
};

template <int D, int BK>
int launch_bf16(const Args& a) {
  const dim3 grid(a.bh, (a.sq + a.block_q - 1) / a.block_q);
  const dim3 block(a.block_q * 2);  // one warp per 16 rows
  flash_fwd_bf16_kernel<D, BK><<<grid, block, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.lse, a.o32, a.sq, a.skv, a.scale,
      a.causal);
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid(a.bh, (a.sq + a.block_q - 1) / a.block_q);
  const dim3 block(a.block_q * TPR);
  flash_fwd_f32_kernel<D, BK><<<grid, block, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.sq,
      a.skv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int dispatch_dim(const Args& a, int dh, int is_bf16) {
  switch (dh) {
    case 16:
      return is_bf16 ? launch_bf16<16, BK>(a) : launch_f32<16, BK>(a);
    case 32:
      return is_bf16 ? launch_bf16<32, BK>(a) : launch_f32<32, BK>(a);
    case 64:
      return is_bf16 ? launch_bf16<64, BK>(a) : launch_f32<64, BK>(a);
    case 128:
      return is_bf16 ? launch_bf16<128, BK>(a) : launch_f32<128, BK>(a);
    default:
      return -1;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, sq|skv, dh) device arrays of one type, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned; lse: nullptr, or a
// contiguous (bh, sq) f32 array that receives each row's logsumexp; o32:
// nullptr, or (bf16 only) a contiguous (bh, sq, dh) f32 array that receives
// the output before its rounding. Launches on `stream` and returns 0, the
// launch's cudaError_t, or a negative code for an unsupported argument:
// -1 head dim, -2 block_k, -3 block_q, -4 o32 with f32 inputs.
extern "C" int rafiki_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, void* o32, int bh, int sq,
                                int skv, int dh, float scale, int causal,
                                int is_bf16, int block_q, int block_k,
                                void* stream) {
  if (block_q != 16 && block_q != 32 && block_q != 64) return -3;
  if (o32 != nullptr && !is_bf16) return -4;
  const Args a{q, k, v, o, static_cast<float*>(lse), static_cast<float*>(o32),
               bh, sq, skv, scale, causal, block_q,
               static_cast<cudaStream_t>(stream)};
  switch (block_k) {
    case 16:
      return dispatch_dim<16>(a, dh, is_bf16);
    case 32:
      return dispatch_dim<32>(a, dh, is_bf16);
    case 64:
      return dispatch_dim<64>(a, dh, is_bf16);
    default:
      return -2;
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
      return "an f32 output copy is for bf16 inputs only";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
