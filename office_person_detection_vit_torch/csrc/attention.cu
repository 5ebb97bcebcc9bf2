// Scaled-dot-product attention with a key padding mask, hand-written for
// Hopper (sm_90a). Two kernels with one contract:
//
//   out[b,h,i,:] = sum_j round_T(p[i,j]) * v[b,h,j,:],
//   p[i,:] = softmax over the valid keys j of (q[b,h,i,:] . k[b,h,j,:]) / sqrt(D)
//
// with q/k/v laid out (B, H, L, D) contiguous, T = float or bfloat16, scores,
// softmax and accumulation in float32, the output in T.
//
// Replaces
//   attention_whole_kv  <- office_person_detection_vit_tpu/ops/attention.py
//                          attention_pallas / _fused_attn_kernel (K1)
//   attention_flash     <- office_person_detection_vit_tpu/ops/attention.py
//                          attention_pallas_flash / _flash_attn_kernel (K2)
// Each rounds where its Pallas kernel does: K1 the normalized probabilities
// (probs.astype(v.dtype) before P.V), K2 the unnormalized p = exp(s - running
// max), with the sum divided out at the end.
//
// What bounds it on an H100. A (batch*head)'s K and V are reused by every
// query row, so at DETR's head dim 32 the long calls are bound by operations:
// the encoder call (8,8,920,920,32) in bf16 does 6.9 GFLOP of QK^T and P.V
// against 15 MB of q, k, v and out (0.0060 ms at 989 TFLOP/s), and it takes
// 54 M exponentials (K1 108 M: its two passes), which the SFUs issue at 16 per
// SM per clock, about as long as the products on the tensor cores. The calls
// with 100 queries (decoder cross- and self-attention, 0.0025 and 0.0005 ms)
// are bound by the bytes of K and V.
//
// bf16 design (tensor cores).
//  * One warp owns 16 query rows. QK^T and P.V are
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: the warp's Q
//    fragments are loaded once from device memory and stay in registers, K
//    fragments come from shared memory by ldmatrix and V fragments by
//    ldmatrix.trans. A 16x64 score tile stays in registers; its accumulator
//    layout is the A layout of the next product, so the rounded bf16 P is
//    repacked in registers into the A fragments of P.V. Row max and sum take
//    two shuffles within the quad of threads that shares a row.
//  * K and V go to shared memory by 16-byte cp.async copies into rows whose
//    16-byte chunks are XOR-swizzled by row, so the eight rows an ldmatrix
//    phase reads fall in eight different bank groups (a bf16 row is 64 B at
//    D = 32, two rows to a 128-B line). Rows past Lk are zero-filled by the
//    copy, so no garbage reaches a product.
//  * The mask becomes a float bias per key in shared memory (0 valid, -inf
//    not), read once per batch entry by each block; s = acc * scale + bias.
//    Ragged Lq and Lk are masked in the kernel; nothing is padded outside.
//  * K1 stages the head's whole K and V, then runs an exact two-pass softmax:
//    pass 1 the row max and normalizer while V is still arriving, pass 2
//    recomputes the scores (cheap on tensor cores at D <= 32) and multiplies
//    the normalized, rounded p by V. With 117,760 B of K/V at 920 keys one
//    block fits on an SM, so a block takes as many warps as the query rows
//    need, up to 16 (256 rows), spread evenly over the blocks of a head: 920
//    rows are 4 blocks of 15 warps, so each SM holds 15 warps and stages K/V
//    once for 240 rows. kernels/attention.py::whole_kv_plan chooses this
//    grid and passes it in; the launch checks that it covers Lq.
//  * K2 is 4 warps (64 rows) that walk K/V in 64-key tiles through a ring of
//    three shared-memory stages: while one tile is computed the next two are
//    in flight (cp.async.commit_group / wait_group), and the mask bytes of
//    the newest tile are loaded into registers and stored as its bias after
//    the current tile's compute. Online max and normalizer as in
//    _flash_attn_kernel; the loop inside the block replaces the TPU's
//    sequential KV grid axis.
//
// float32 keeps the CUDA-core body (four threads per query row, float32 FMAs,
// 64-row blocks): TF32 tensor cores would break its 1e-5 tolerance and the
// whole-model float32 bar, and at the encoder shape K2 in float32 already ran
// level with SDPA in float32 (0.4890 against 0.4934 ms, NVIDIA H100 80GB
// HBM3, 700.00 W, chip_smoke.py phase 2).
//
// A batch entry whose keys are all masked gives mean(V) over its Lk keys, as
// the plain version (attention_reference) does: all keys count as valid with
// score 0. DETR's pixel mask never produces one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int any_valid_key(const uint8_t* mask_b, int Lk) {
  int any = 0;
  if (mask_b == nullptr) {
    any = 1;
  } else {
    for (int j = threadIdx.x; j < Lk && !any; j += blockDim.x) any = mask_b[j] != 0;
  }
  return __syncthreads_or(any);
}

// ======================================================= float32 (CUDA cores)
constexpr int kRows = 64;              // query rows per block
constexpr int kSplit = 4;              // threads per query row
constexpr int kThreads = kRows * kSplit;
constexpr int kFlashKeys = 64;         // keys per K2 tile
constexpr int kVec = 4;                // floats per 16-byte chunk

template <int D> struct Layout {
  static constexpr int kChunks = D / kVec;            // chunks per row
  static constexpr int kRowsPerLine = D * 4 >= 128 ? 1 : 128 / (D * 4);
  static constexpr int kSwizzle = kChunks < 4 ? kChunks : 4;
  // Physical chunk of logical chunk c in row j.
  __device__ __forceinline__ static int chunk(int j, int c) {
    return c ^ ((j / kRowsPerLine) % kSwizzle);
  }
};

__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// Copy rows [0, n) of a (n, D) row-major global array into swizzled shared rows.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  using L = Layout<D>;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int e = threadIdx.x; e < n * L::kChunks; e += kThreads) {
    const int j = e / L::kChunks, c = e % L::kChunks;
    d[j * L::kChunks + L::chunk(j, c)] = s[e];
  }
}

// q . k_j for one swizzled shared row j.
template <int D>
__device__ __forceinline__ float dot_row(const float* rows, int j, const float* q) {
  using L = Layout<D>;
  const uint4* r = reinterpret_cast<const uint4*>(rows) + j * L::kChunks;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    float x[kVec];
    unpack(r[L::chunk(j, c)], x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(q[c * kVec + e], x[e], acc);
  }
  return acc;
}

// acc += p * v_j for one swizzled shared row j.
template <int D>
__device__ __forceinline__ void axpy_row(const float* rows, int j, float p, float* acc) {
  using L = Layout<D>;
  const uint4* r = reinterpret_cast<const uint4*>(rows) + j * L::kChunks;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    float x[kVec];
    unpack(r[L::chunk(j, c)], x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[c * kVec + e] = fmaf(p, x[e], acc[c * kVec + e]);
  }
}

// Load this thread's query row (unswizzled, row-major global).
template <int D>
__device__ __forceinline__ void load_query(const float* qrow, float* q) {
  const uint4* r = reinterpret_cast<const uint4*>(qrow);
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c) unpack(r[c], q + c * kVec);
}

// Merge (max, sum) of the kSplit threads of a row, scaling the sums.
__device__ __forceinline__ void merge_stats(float& m, float& l, float& scale_self) {
  float mrow = m;
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, o));
  scale_self = (m == -INFINITY) ? 0.f : exp2f(m - mrow);
  float lrow = l * scale_self;
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) lrow += __shfl_xor_sync(0xffffffffu, lrow, o);
  m = mrow;
  l = lrow;
}

// Sum the row's partial outputs across its kSplit threads and write it.
template <int D>
__device__ __forceinline__ void write_row(float* acc, float inv, float* orow, int split, bool live) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d / (D / kSplit) == split) orow[d] = acc[d] * inv;
  }
}

// Stage the batch entry's mask bytes for keys [k0, k0 + n).
__device__ __forceinline__ void stage_mask(uint8_t* dst, const uint8_t* mask_b, int k0, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = mask_b ? (mask_b[k0 + j] != 0) : 1;
}

// ---------------------------------------------------------------- K1, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_whole_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const uint8_t* __restrict__ mask,
                          float* __restrict__ out, int H, int Lq, int Lk, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + (size_t)Lk * D;
  float* sq = sv + (size_t)Lk * D;
  uint8_t* smask = reinterpret_cast<uint8_t*>(sq + kRows * D);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  stage_rows<D>(sk, k + kv_off, Lk);
  stage_rows<D>(sv, v + kv_off, Lk);
  {
    const uint4* s = reinterpret_cast<const uint4*>(q + ((size_t)bh * Lq + q0) * D);
    uint4* d = reinterpret_cast<uint4*>(sq);
    for (int e = threadIdx.x; e < nq * Layout<D>::kChunks; e += kThreads) d[e] = s[e];
  }
  stage_mask(smask, mask_b, 0, Lk);
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the staging

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const bool live = row < nq;
  float qf[D];
  load_query<D>(sq + (live ? row : 0) * D, qf);

  // Pass 1: row max and normalizer (online over this thread's keys).
  float m = -INFINITY, l = 0.f;
  if (live) {
    for (int j = split; j < Lk; j += kSplit) {
      if (!all_masked && !smask[j]) continue;
      const float s = all_masked ? 0.f : dot_row<D>(sk, j, qf) * scale_log2;
      if (s > m) {
        l = l * exp2f(m - s) + 1.f;
        m = s;
      } else {
        l += exp2f(s - m);
      }
    }
  }
  float unused;
  merge_stats(m, l, unused);
  const float inv_l = live ? 1.f / l : 0.f;

  // Pass 2: normalized probabilities times V.
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (live) {
    for (int j = split; j < Lk; j += kSplit) {
      if (!all_masked && !smask[j]) continue;
      const float s = all_masked ? 0.f : dot_row<D>(sk, j, qf) * scale_log2;
      axpy_row<D>(sv, j, exp2f(s - m) * inv_l, acc);
    }
  }
  write_row<D>(acc, 1.f, out + ((size_t)bh * Lq + q0 + row) * D, split, live);
}

// ---------------------------------------------------------------- K2, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int H, int Lq, int Lk, float scale_log2) {
  __shared__ __align__(16) float sk[kFlashKeys * D];
  __shared__ __align__(16) float sv[kFlashKeys * D];
  __shared__ uint8_t smask[kFlashKeys];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const bool live = row < nq;
  float qf[D];
  load_query<D>(q + ((size_t)bh * Lq + q0 + (live ? row : 0)) * D, qf);

  constexpr int kPer = kFlashKeys / kSplit;  // keys per thread per tile
  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
    const int nk = min(kFlashKeys, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<D>(sk, k + kv_off + (size_t)k0 * D, nk);
    stage_rows<D>(sv, v + kv_off + (size_t)k0 * D, nk);
    stage_mask(smask, mask_b, k0, nk);
    __syncthreads();
    if (!live) continue;

    float s[kPer];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = i * kSplit + split;
      const bool valid = j < nk && (all_masked || smask[j]);
      s[i] = !valid ? -INFINITY : (all_masked ? 0.f : dot_row<D>(sk, j, qf) * scale_log2);
      tile_max = fmaxf(tile_max, s[i]);
    }
    if (tile_max == -INFINITY) continue;  // no valid key of this thread in the tile
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);  // 0 while m is -inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (s[i] == -INFINITY) continue;
      const float p = exp2f(s[i] - m_new);
      l += p;
      axpy_row<D>(sv, i * kSplit + split, p, acc);
    }
    m = m_new;
  }

  float self_scale;
  merge_stats(m, l, self_scale);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= self_scale;
  write_row<D>(acc, live ? 1.f / l : 0.f, out + ((size_t)bh * Lq + q0 + row) * D, split, live);
}

// ===================================================== bf16 (tensor cores)
constexpr int kWarpRows = 16;          // query rows per warp (one m16 tile)
constexpr int kTileKeys = 64;          // keys per score tile
constexpr int kWholeKvMaxWarps = 16;   // K1: at most 256 query rows a block (launch bounds)
constexpr int kFlashWarps = 4;         // K2: 64 query rows a block
constexpr int kFlashStages = 3;        // K2: tiles in the shared-memory ring

// smem_u32, cp_async16/commit/wait, ldsm_x4(_trans), mma_bf16 and pack_bf16
// come from sm90.cuh.

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 rows of D values in shared memory, 16-byte chunks XOR-swizzled by row.
template <int D> struct Rows {
  static_assert(D == 16 || D == 32, "head dim 16 or 32");
  static constexpr int kBytes = 2 * D;
  static constexpr int kChunks = D / 8;
  static constexpr int kPerLine = 128 / kBytes;
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    return r * kBytes + ((c ^ ((r / kPerLine) % kChunks)) << 4);
  }
};

// Copy rows [0, n_rows) from a row-major global array into swizzled shared
// rows; rows from n_valid on are zero-filled.
template <int D>
__device__ __forceinline__ void stage_async(uint32_t dst, const bf16* src, int n_valid,
                                            int n_rows) {
  using R = Rows<D>;
  for (int e = threadIdx.x; e < n_rows * R::kChunks; e += blockDim.x) {
    const int r = e / R::kChunks, c = e % R::kChunks;
    const bool full = r < n_valid;
    cp_async16(dst + R::offset(r, c), src + (full ? (size_t)e * 8 : 0), full);
  }
}

// The warp's A fragments of Q (16 rows from row0), straight from device
// memory; rows at or past Lq are zero.
template <int D>
__device__ __forceinline__ void load_q(const bf16* q_bh, int row0, int Lq,
                                       uint32_t (&qa)[D / 16][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(q_bh + (size_t)(row0 + g) * D);
  const uint32_t* r1 = r0 + 8 * D / 2;
  const bool v0 = row0 + g < Lq, v1 = row0 + g + 8 < Lq;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = v0 ? r0[8 * kk + t] : 0u;
    qa[kk][1] = v1 ? r1[8 * kk + t] : 0u;
    qa[kk][2] = v0 ? r0[8 * kk + 4 + t] : 0u;
    qa[kk][3] = v1 ? r1[8 * kk + 4 + t] : 0u;
  }
}

// s = (Q K^T) * scale + bias for the 64 keys from key0 of the swizzled rows at
// sk. s[n] is the m16n8 accumulator of keys key0 + 8n .. + 7: s[n][0..1] row
// g, keys 2t, 2t+1; s[n][2..3] row g + 8.
template <int D>
__device__ __forceinline__ void score_tile(const uint32_t (&qa)[D / 16][4], uint32_t sk,
                                           const float* bias, int key0, float scale,
                                           float (&s)[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // 8 key groups x D/8 chunks = D 8x8 matrices, four per ldmatrix.
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const int m = 4 * c + lane / 8;
    uint32_t b[4];
    ldsm_x4(sk + Rows<D>::offset(key0 + 8 * (m / (D / 8)) + lane % 8, m % (D / 8)), b);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int mi = 4 * c + i;  // chunks 2kk and 2kk+1 of one key group
      mma_bf16(s[mi / (D / 8)], qa[(mi % (D / 8)) / 2], b[i], b[i + 1]);
    }
  }
  const int t = lane % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + key0 + 8 * n + 2 * t);
    s[n][0] = fmaf(s[n][0], scale, bb.x);
    s[n][1] = fmaf(s[n][1], scale, bb.y);
    s[n][2] = fmaf(s[n][2], scale, bb.x);
    s[n][3] = fmaf(s[n][3], scale, bb.y);
  }
}

// o += P V for the 64 keys from key0 of the swizzled rows at sv; pa[kk] is
// the A fragment of keys key0 + 16kk .. + 15.
template <int D>
__device__ __forceinline__ void pv_tile(const uint32_t (&pa)[4][4], uint32_t sv, int key0,
                                        float (&o)[D / 8][4]) {
  const int lane = threadIdx.x % 32;
  // 4 key steps x D/8 column groups x 2 key halves = D matrices.
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const int m = 4 * c + lane / 8;
    const int half = m % 2, dn = (m / 2) % (D / 8), kk = m / (D / 4);
    uint32_t b[4];
    ldsm_x4_trans(sv + Rows<D>::offset(key0 + 16 * kk + 8 * half + lane % 8, dn), b);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int mi = 4 * c + i;  // both key halves of one column group
      mma_bf16(o[(mi / 2) % (D / 8)], pa[mi / (D / 4)], b[i], b[i + 1]);
    }
  }
}

// Round p (a score tile's layout) to bf16 and repack it as P.V's A fragments.
__device__ __forceinline__ void pack_p(const float (&p)[8][4], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// Max of the quad's values: the four threads that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// This thread's max of rows g (r = 0) and g + 8 (r = 1) over a score tile.
__device__ __forceinline__ void tile_max(const float (&s)[8][4], float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
}

// Write the warp's 16 output rows (o times inv per row) as bf16.
template <int D>
__device__ __forceinline__ void store_o(const float (&o)[D / 8][4], const float (&inv)[2],
                                        bf16* o_bh, int row0, int Lq) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Lq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(o_bh + (size_t)row * D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      dst[4 * dn + t] = pack_bf16(o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
  }
}

__device__ __forceinline__ float key_bias(const uint8_t* mask_b, int j, int Lk, bool all_masked) {
  return (j < Lk && (all_masked || mask_b == nullptr || mask_b[j])) ? 0.f : -INFINITY;
}

template <int D>
size_t whole_kv_bf16_smem_bytes(int Lk) {
  const size_t keys = (size_t)(Lk + kTileKeys - 1) / kTileKeys * kTileKeys;
  return 2 * keys * D * sizeof(bf16) + keys * sizeof(float);
}

// ------------------------------------------------------------------- K1, bf16
template <int D>
__global__ void __launch_bounds__(kWholeKvMaxWarps * 32)
attention_whole_kv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                       bf16* __restrict__ out, int H, int Lq, int Lk, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem_kv[];
  const int keys = (Lk + kTileKeys - 1) / kTileKeys * kTileKeys;
  const uint32_t sk = smem_u32(smem_kv);
  const uint32_t sv = sk + keys * Rows<D>::kBytes;
  float* bias = reinterpret_cast<float*>(smem_kv + 2 * keys * Rows<D>::kBytes);

  const int bh = blockIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const size_t kv_off = (size_t)bh * Lk * D;
  stage_async<D>(sk, k + kv_off, Lk, keys);
  cp_async_commit();
  stage_async<D>(sv, v + kv_off, Lk, keys);
  cp_async_commit();

  const bool all_masked = !any_valid_key(mask_b, Lk);
  for (int j = threadIdx.x; j < keys; j += blockDim.x) bias[j] = key_bias(mask_b, j, Lk, all_masked);
  const float scale = all_masked ? 0.f : scale_log2;

  const int row0 = blockIdx.y * (blockDim.x / 32) * kWarpRows + threadIdx.x / 32 * kWarpRows;
  const bool live = row0 < Lq;
  const bf16* q_bh = q + (size_t)bh * Lq * D;
  uint32_t qa[D / 16][4];
  load_q<D>(q_bh, row0, Lq, qa);

  cp_async_wait<1>();  // K has landed (V may still be in flight)
  __syncthreads();

  // Pass 1: row max and normalizer, online over this thread's keys.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (live) {
    for (int key0 = 0; key0 < keys; key0 += kTileKeys) {
      float s[8][4], mx[2];
      score_tile<D>(qa, sk, bias, key0, scale, s);
      tile_max(s, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) sum += ex2(s[n][2 * r] - mu) + ex2(s[n][2 * r + 1] - mu);
        l[r] = l[r] * ex2(m[r] - mu) + sum;
        m[r] = m_new;
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mrow = quad_max(m[r]);
    const float mu = mrow == -INFINITY ? 0.f : mrow;
    inv[r] = 1.f / quad_sum(l[r] * ex2(m[r] - mu));
    m[r] = mu;
  }

  cp_async_wait<0>();  // V
  __syncthreads();
  if (!live) return;

  // Pass 2: the normalized probabilities, rounded to bf16, times V.
  float o[D / 8][4] = {};
  for (int key0 = 0; key0 < keys; key0 += kTileKeys) {
    float s[8][4];
    score_tile<D>(qa, sk, bias, key0, scale, s);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ex2(s[n][e] - m[e / 2]) * inv[e / 2];
    uint32_t pa[4][4];
    pack_p(s, pa);
    pv_tile<D>(pa, sv, key0, o);
  }
  const float one[2] = {1.f, 1.f};
  store_o<D>(o, one, out + (size_t)bh * Lq * D, row0, Lq);
}

// ------------------------------------------------------------------- K2, bf16
template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, 4)
attention_flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ out, int H, int Lq, int Lk, float scale_log2) {
  __shared__ __align__(128) bf16 ring_k[kFlashStages][kTileKeys * D];
  __shared__ __align__(128) bf16 ring_v[kFlashStages][kTileKeys * D];
  __shared__ __align__(16) float ring_bias[kFlashStages][kTileKeys];

  const int bh = blockIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bf16* k_bh = k + (size_t)bh * Lk * D;
  const bf16* v_bh = v + (size_t)bh * Lk * D;
  const int tiles = (Lk + kTileKeys - 1) / kTileKeys;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const float scale = all_masked ? 0.f : scale_log2;
  const int tid = threadIdx.x;

  // Start tile t's K/V copies into its ring slot (an empty group past the end).
  auto issue = [&](int t) {
    if (t < tiles) {
      const int k0 = t * kTileKeys, n = min(kTileKeys, Lk - k0);
      stage_async<D>(smem_u32(ring_k[t % kFlashStages]), k_bh + (size_t)k0 * D, n, kTileKeys);
      stage_async<D>(smem_u32(ring_v[t % kFlashStages]), v_bh + (size_t)k0 * D, n, kTileKeys);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kFlashStages - 1; ++t) {
    issue(t);
    if (tid < kTileKeys) ring_bias[t][tid] = key_bias(mask_b, t * kTileKeys + tid, Lk, all_masked);
  }

  const int row0 = blockIdx.y * kFlashWarps * kWarpRows + tid / 32 * kWarpRows;
  const bool live = row0 < Lq;
  uint32_t qa[D / 16][4];
  load_q<D>(q + (size_t)bh * Lq * D, row0, Lq, qa);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFlashStages - 2>();  // tile t has landed
    __syncthreads();                    // ... for every thread; tile t - 1's slot is free
    const int next = t + kFlashStages - 1;
    issue(next);
    // The newest tile's mask bytes load while this tile is computed.
    const float next_bias =
        tid < kTileKeys ? key_bias(mask_b, next * kTileKeys + tid, Lk, all_masked) : 0.f;

    if (live) {
      const int slot = t % kFlashStages;
      float s[8][4], mx[2];
      score_tile<D>(qa, smem_u32(ring_k[slot]), ring_bias[slot], 0, scale, s);
      tile_max(s, mx);
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m[r] - mu[r]);  // 0 while m is -inf
        l[r] *= alpha;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          o[dn][2 * r] *= alpha;
          o[dn][2 * r + 1] *= alpha;
        }
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(s[n][e] - mu[e / 2]);
          l[e / 2] += s[n][e];
        }
      uint32_t pa[4][4];
      pack_p(s, pa);
      pv_tile<D>(pa, smem_u32(ring_v[slot]), 0, o);
    }
    if (tid < kTileKeys) ring_bias[next % kFlashStages][tid] = next_bias;
  }
  cp_async_wait<0>();
  if (!live) return;
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  store_o<D>(o, inv, out + (size_t)bh * Lq * D, row0, Lq);
}

// ===================================================================== launch
size_t whole_kv_f32_smem_bytes(int Lk, int D) {
  return (size_t)2 * Lk * D * sizeof(float) + (size_t)kRows * D * sizeof(float) + Lk;
}

// K1's grid: `blocks` query-row blocks per (batch*head) of `threads`
// threads each, as kernels/attention.py::whole_kv_plan gives it. K2's grid
// has no choice in it and is set here.
template <int D>
cudaError_t launch_f32(bool flash, const float* q, const float* k, const float* v,
                       const uint8_t* mask, float* out, int B, int H, int Lq, int Lk,
                       int blocks, int threads, float scale_log2, cudaStream_t stream) {
  if (flash) {
    const dim3 grid(B * H, (Lq + kRows - 1) / kRows);
    attention_flash_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, mask, out, H, Lq, Lk,
                                                             scale_log2);
  } else {
    if (threads != kThreads || blocks < 1 || blocks * kRows < Lq) return cudaErrorInvalidValue;
    const dim3 grid(B * H, blocks);
    const size_t smem = whole_kv_f32_smem_bytes(Lk, D);
    cudaError_t err = cudaFuncSetAttribute(attention_whole_kv_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attention_whole_kv_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, H, Lq, Lk,
                                                                   scale_log2);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(bool flash, const bf16* q, const bf16* k, const bf16* v,
                        const uint8_t* mask, bf16* out, int B, int H, int Lq, int Lk,
                        int blocks, int threads, float scale_log2, cudaStream_t stream) {
  if (flash) {
    const int warp_tiles = (Lq + kWarpRows - 1) / kWarpRows;
    const dim3 grid(B * H, (warp_tiles + kFlashWarps - 1) / kFlashWarps);
    attention_flash_mma<D><<<grid, kFlashWarps * 32, 0, stream>>>(q, k, v, mask, out, H, Lq, Lk,
                                                                  scale_log2);
  } else {
    const int warps = threads / 32;
    if (threads % 32 != 0 || warps < 1 || warps > kWholeKvMaxWarps || blocks < 1 ||
        blocks * warps * kWarpRows < Lq)
      return cudaErrorInvalidValue;
    const size_t smem = whole_kv_bf16_smem_bytes<D>(Lk);
    cudaError_t err = cudaFuncSetAttribute(attention_whole_kv_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attention_whole_kv_mma<D><<<dim3(B * H, blocks), warps * 32, smem, stream>>>(
        q, k, v, mask, out, H, Lq, Lk, scale_log2);
  }
  return cudaGetLastError();
}

int dispatch(bool flash, int dtype, const void* q, const void* k, const void* v,
             const void* mask, void* out, int B, int H, int Lq, int Lk, int D, int blocks,
             int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = kLog2e / std::sqrt((float)D);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* fo = static_cast<float*>(out);
    if (D == 16)
      err = launch_f32<16>(flash, fq, fk, fv, m, fo, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 32)
      err = launch_f32<32>(flash, fq, fk, fv, m, fo, B, H, Lq, Lk, blocks, threads, scale_log2, s);
  } else if (dtype == 1) {
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v);
    bf16* bo = static_cast<bf16*>(out);
    if (D == 16)
      err = launch_bf16<16>(flash, bq, bk, bv, m, bo, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 32)
      err = launch_bf16<32>(flash, bq, bk, bv, m, bo, B, H, Lq, Lk, blocks, threads, scale_log2, s);
  }
  return (int)err;
}

// Every attention kernel instantiation, for attention_kernel_attributes.
struct Entry {
  const char* name;
  const void* fn;
};
const Entry kKernels[] = {
    {"attention_whole_kv_mma<bf16,16>", (const void*)attention_whole_kv_mma<16>},
    {"attention_whole_kv_mma<bf16,32>", (const void*)attention_whole_kv_mma<32>},
    {"attention_flash_mma<bf16,16>", (const void*)attention_flash_mma<16>},
    {"attention_flash_mma<bf16,32>", (const void*)attention_flash_mma<32>},
    {"attention_whole_kv_kernel<float,16>", (const void*)attention_whole_kv_kernel<16>},
    {"attention_whole_kv_kernel<float,32>", (const void*)attention_whole_kv_kernel<32>},
    {"attention_flash_kernel<float,16>", (const void*)attention_flash_kernel<16>},
    {"attention_flash_kernel<float,32>", (const void*)attention_flash_kernel<32>},
};

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mask: (B, Lk) bytes (torch.bool), or null for no mask. stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success). K1 takes
// its grid (blocks per batch*head, threads a block) from
// kernels/attention.py::whole_kv_plan, and refuses one that leaves query rows
// without a warp (cudaErrorInvalidValue).
extern "C" int attention_whole_kv(int dtype, const void* q, const void* k, const void* v,
                                  const void* mask, void* out, int B, int H, int Lq, int Lk,
                                  int D, int blocks, int threads, void* stream) {
  return dispatch(false, dtype, q, k, v, mask, out, B, H, Lq, Lk, D, blocks, threads, stream);
}

extern "C" int attention_flash(int dtype, const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int H, int Lq, int Lk, int D,
                               void* stream) {
  return dispatch(true, dtype, q, k, v, mask, out, B, H, Lq, Lk, D, 0, 0, stream);
}

// The compiled resources of attention kernel i (0 <= i < count, in the order
// of kKernels): name, registers a thread, local (spill) bytes a thread, static
// shared bytes, most threads a block. Returns the cudaError_t, or
// cudaErrorInvalidValue past the end.
extern "C" int attention_kernel_attributes(int i, const char** name, int* regs, int* local_bytes,
                                           int* static_smem, int* max_threads) {
  if (i < 0 || i >= (int)(sizeof(kKernels) / sizeof(kKernels[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kKernels[i].fn);
  if (err != cudaSuccess) return (int)err;
  *name = kKernels[i].name;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

// The message of a cudaError_t, for every kernel of the library.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
