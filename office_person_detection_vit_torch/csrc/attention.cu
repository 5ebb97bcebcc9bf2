// Scaled-dot-product attention with a key padding mask, hand-written for
// Hopper (sm_90a). Two forward kernels with one contract:
//
//   out[b,h,i,:] = sum_j round_T(p[i,j]) * v[b,h,j,:],
//   p[i,:] = softmax over the valid keys j of (q[b,h,i,:] . k[b,h,j,:]) / sqrt(D)
//
// with q/k/v laid out (B, H, L, D) contiguous, T = float or bfloat16, scores,
// softmax and accumulation in float32, the output in T. Given a pointer, K2
// (both types) and K1's float32 body also write lse[b,h,i], the float32
// natural log-sum-exp of row i's scaled, biased scores, for the backward; a
// null pointer writes nothing and changes nothing else. The backward pair is
// at the end of this file.
//
// Replaces
//   attention_whole_kv  <- office_person_detection_vit_tpu/ops/attention.py
//                          attention_pallas / _fused_attn_kernel (K1)
//   attention_flash     <- office_person_detection_vit_tpu/ops/attention.py
//                          attention_pallas_flash / _flash_attn_kernel (K2)
//   attention_backward  <- office_person_detection_vit_tpu/ops/attention.py
//                          _attention_pallas_diff's backward, _attn_bwd (B.4)
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
// bf16 design (tensor cores). K2 and the backward pair at head dims 64,
// 128, 192 and 256 run the Hopper bodies of the wgmma section below (two
// warpgroups of 64 rows, TMA, wgmma; ViT-base/16's D 64, ViT-H/16's 80
// padded to 128, the VITW DETR's 256).
// K1 at every head dim, and K2 and the pair at 16 and 32 (DETR's), run the
// mma.sync bodies described here:
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
//    phase reads fall in eight different bank groups: a bf16 row is 32 B at
//    D = 16 (four rows to a 128-B line, the chunk XORed with bit 2 of the
//    row), 64 B at D = 32 (two rows to a line, XORed with bits 1-2),
//    128 B at D = 64 (a row a line, its eight chunks XORed with the row's
//    low three bits) and 256 B at D = 128 (a row two lines, each chunk's
//    low three bits XORed with the row's). Rows past Lk are zero-filled by
//    the copy, so no garbage reaches a product.
//  * Head dims 16, 32, 64 and 128 are instantiated; kernels/attention.py
//    pads any other D <= 128 with zero columns up to the next of them and
//    passes the true scale 1/sqrt(D), which every entry point takes as an
//    argument. Above 128 the wrapper pads D up to a multiple of 64: bf16
//    K2 and the pair take the wgmma bodies at 192 and 256, and everything
//    else there the chunked bodies of the C.7 section below.
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
//    sequential KV grid axis. The ring is dynamic shared memory (Ring<D>).
//    At D = 128 K1 takes at most 8 warps a block (255 registers a thread
//    instead of 128).
//
// float32 keeps the CUDA-core body (four threads per query row, float32 FMAs,
// 64-row blocks): TF32 tensor cores would break its 1e-5 tolerance and the
// whole-model float32 bar, and at the encoder shape K2 in float32 already ran
// level with SDPA in float32 (0.4890 against 0.4934 ms, NVIDIA H100 80GB
// HBM3, 700.00 W, chip_smoke.py phase 2). Up to D = 64 a row's four threads
// split its keys and each keeps the whole row of q and of the output; at
// D = 128 that is 256 floats a thread, so the *_slice bodies split the head
// dim instead (each thread a quarter of q and of the output, the quad
// summing each dot product with two shuffles), and stage K/V in dynamic
// shared memory (64 KB a tile, over the 48 KB a static array may take).
//
// A batch entry whose keys are all masked gives mean(V) over its Lk keys, as
// the plain version (attention_reference) does: all keys count as valid with
// score 0. DETR's pixel mask never produces one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
  // Physical chunk of logical chunk c in row j. At D = 128 the quarter c / 8
  // (the slice of one of a row's four threads, which read one row together)
  // adds to the XOR, so the four read four different bank groups.
  __device__ __forceinline__ static int chunk(int j, int c) {
    return c ^ ((j / kRowsPerLine + (D > 64 ? c / 8 : 0)) % kSwizzle);
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
                          float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                          float scale_log2) {
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
  if (lse != nullptr && live && split == 0) lse[(size_t)bh * Lq + q0 + row] = (m + log2f(l)) * kLn2;

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
                       float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                       float scale_log2) {
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
  if (lse != nullptr && live && split == 0) lse[(size_t)bh * Lq + q0 + row] = (m + log2f(l)) * kLn2;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= self_scale;
  write_row<D>(acc, live ? 1.f / l : 0.f, out + ((size_t)bh * Lq + q0 + row) * D, split, live);
}

// ===================================================== bf16 (tensor cores)
constexpr int kWarpRows = 16;          // query rows per warp (one m16 tile)
constexpr int kTileKeys = 64;          // keys per score tile
// K1: at most 256 query rows a block (launch bounds); 128 at D = 128, where
// a thread needs more than the 128 registers 16 warps leave it.
constexpr int whole_kv_max_warps(int D) { return D <= 64 ? 16 : 8; }
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
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  static constexpr int kBytes = 2 * D;
  static constexpr int kChunks = D / 8;
  static constexpr int kPerLine = kBytes >= 128 ? 1 : 128 / kBytes;
  static constexpr int kSwizzle = kChunks < 8 ? kChunks : 8;  // 16-byte chunks in a 128-B line
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    return r * kBytes + ((c ^ ((r / kPerLine) % kSwizzle)) << 4);
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

// s = A B^T for the warp's 16 rows of A (fragments a, D deep) and the 8N
// rows (64 by default) from row0 of the swizzled rows at sb. s[n] is the
// m16n8 accumulator of B rows row0 + 8n .. + 7: s[n][0..1] A row g, B rows
// 2t, 2t+1; s[n][2..3] A row g + 8.
template <int D, int N = 8>
__device__ __forceinline__ void product_tile(const uint32_t (&a)[D / 16][4], uint32_t sb, int row0,
                                             float (&s)[N][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < N; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // N row groups x D/8 chunks = N D / 8 8x8 matrices, four per ldmatrix.
#pragma unroll
  for (int c = 0; c < N * D / 32; ++c) {
    const int m = 4 * c + lane / 8;
    uint32_t b[4];
    ldsm_x4(sb + Rows<D>::offset(row0 + 8 * (m / (D / 8)) + lane % 8, m % (D / 8)), b);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int mi = 4 * c + i;  // chunks 2kk and 2kk+1 of one row group
      mma_bf16(s[mi / (D / 8)], a[(mi % (D / 8)) / 2], b[i], b[i + 1]);
    }
  }
}

// s = (Q K^T) * scale + bias for the 8N keys from key0 of the swizzled rows
// at sk, in product_tile's layout (B rows = keys).
template <int D, int N = 8>
__device__ __forceinline__ void score_tile(const uint32_t (&qa)[D / 16][4], uint32_t sk,
                                           const float* bias, int key0, float scale,
                                           float (&s)[N][4]) {
  product_tile<D, N>(qa, sk, key0, s);
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + key0 + 8 * n + 2 * t);
    s[n][0] = fmaf(s[n][0], scale, bb.x);
    s[n][1] = fmaf(s[n][1], scale, bb.y);
    s[n][2] = fmaf(s[n][2], scale, bb.x);
    s[n][3] = fmaf(s[n][3], scale, bb.y);
  }
}

// o += P V for the 16KK keys (64 by default) from key0 of the swizzled rows
// at sv, over the DO columns (all D by default) from column chunk c0 (8
// columns a chunk); pa[kk] is the A fragment of keys key0 + 16kk .. + 15.
template <int D, int KK = 4, int DO = D>
__device__ __forceinline__ void pv_tile(const uint32_t (&pa)[KK][4], uint32_t sv, int key0,
                                        float (&o)[DO / 8][4], int c0 = 0) {
  const int lane = threadIdx.x % 32;
  // KK key steps x DO/8 column groups x 2 key halves = KK DO / 4 matrices.
#pragma unroll
  for (int c = 0; c < KK * DO / 16; ++c) {
    const int m = 4 * c + lane / 8;
    const int half = m % 2, dn = (m / 2) % (DO / 8), kk = m / (DO / 4);
    uint32_t b[4];
    ldsm_x4_trans(sv + Rows<D>::offset(key0 + 16 * kk + 8 * half + lane % 8, c0 + dn), b);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int mi = 4 * c + i;  // both key halves of one column group
      mma_bf16(o[(mi / 2) % (DO / 8)], pa[mi / (DO / 4)], b[i], b[i + 1]);
    }
  }
}

// Round p (a score tile's layout, 8N keys) to bf16 and repack it as P.V's A
// fragments.
template <int N = 8>
__device__ __forceinline__ void pack_p(const float (&p)[N][4], uint32_t (&pa)[N / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
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

// Write the warp's 16 output rows (o times inv per row) as bf16: the DO
// columns (all D by default) from column col0 of rows D wide.
template <int D, int DO = D>
__device__ __forceinline__ void store_o(const float (&o)[DO / 8][4], const float (&inv)[2],
                                        bf16* o_bh, int row0, int Lq, int col0 = 0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Lq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(o_bh + (size_t)row * D + col0);
#pragma unroll
    for (int dn = 0; dn < DO / 8; ++dn)
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

// The ring of K2 and of the backward pair, in dynamic shared memory:
// kFlashStages slots of two 64-row bf16 tiles (K and V, or Q and g), then
// kVecs float vectors of 64 per slot (the key bias; lse2 and D).
template <int D, int kVecs> struct Ring {
  static constexpr int kTile = kTileKeys * D * (int)sizeof(bf16);
  static constexpr size_t kBytes = kFlashStages * (2 * kTile + kVecs * kTileKeys * sizeof(float));
  // Shared addresses of slot s of the first and second tile, and vector i of slot s.
  __device__ __forceinline__ static uint32_t a(uint32_t base, int s) { return base + s * kTile; }
  __device__ __forceinline__ static uint32_t b(uint32_t base, int s) {
    return base + (kFlashStages + s) * kTile;
  }
  __device__ __forceinline__ static float* vec(uint8_t* base, int i, int s) {
    return reinterpret_cast<float*>(base + 2 * kFlashStages * kTile) + (i * kFlashStages + s) * kTileKeys;
  }
};

// Opt a kernel in to `bytes` of dynamic shared memory (needed above 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ------------------------------------------------------------------- K1, bf16
template <int D>
__global__ void __launch_bounds__(whole_kv_max_warps(D) * 32)
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
                    bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                    float scale_log2) {
  using R = Ring<D, 1>;
  extern __shared__ __align__(128) uint8_t smem_kv[];
  const uint32_t ring = smem_u32(smem_kv);
  auto ring_bias = [&](int s) { return R::vec(smem_kv, 0, s); };

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
      stage_async<D>(R::a(ring, t % kFlashStages), k_bh + (size_t)k0 * D, n, kTileKeys);
      stage_async<D>(R::b(ring, t % kFlashStages), v_bh + (size_t)k0 * D, n, kTileKeys);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kFlashStages - 1; ++t) {
    issue(t);
    if (tid < kTileKeys) ring_bias(t)[tid] = key_bias(mask_b, t * kTileKeys + tid, Lk, all_masked);
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
      score_tile<D>(qa, R::a(ring, slot), ring_bias(slot), 0, scale, s);
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
      pv_tile<D>(pa, R::b(ring, slot), 0, o);
    }
    if (tid < kTileKeys) ring_bias(next % kFlashStages)[tid] = next_bias;
  }
  cp_async_wait<0>();
  if (!live) return;
  const float sum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  store_o<D>(o, inv, out + (size_t)bh * Lq * D, row0, Lq);
  if (lse != nullptr && tid % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (tid % 32) / 4 + 8 * r;
      if (row < Lq) lse[(size_t)bh * Lq + row] = (m[r] + log2f(sum[r])) * kLn2;
    }
  }
}

// ================================================== backward (B.4), both types
// The vector-Jacobian product of the plain version (attention_reference) at
// (q, k, v) for the output gradient g, as FlashAttention-2 computes it: the
// probabilities are recomputed tile by tile from the forward's log-sum-exp,
// so no (Lq, Lk) array exists:
//
//   P = exp(S - lse), D_i = sum_d g[i,d] out[i,d], dP = g V^T,
//   dS = P * (dP - D), dQ = scale dS K, dK = scale dS^T Q, dV = P^T g,
//
// with S the forward's scaled, biased scores and scale = 1/sqrt(D). An entry
// whose keys are all masked has S = 0 on every key (the forward's zero score
// scale) but keeps the true scale in dQ and dK: the plain version's autograd
// passes the score gradient through its -1e30 bias, so they are not zero.
//
// Two launches, deterministic (no atomics). The dQ kernel: one block per 64
// query rows of a (batch*head), walking K/V tiles through K2's ring; first it
// writes, for its rows, lse in base 2 (+inf past Lq, so that padded rows get
// P = 0) and D to a float32 scratch of Lq rounded up to its row blocks
// (scratch_rows: 64 here, 128 for the Hopper pair). Then the dK/dV kernel:
// one block per 64 keys, which keeps its K, V and key bias and
// walks 64-row tiles of Q, g and the scratch through the same kind of ring.
//
// What bounds it on an H100: seven products of 2 Lq Lk D flops over the
// valid keys (QK^T and gV^T in both kernels, dS K, P^T g, dS^T Q), 10 flops a
// query-key-dim counting the recomputed two once, on the tensor cores in
// bf16, against the bytes of q, k, v, out, g, dq, dk, dv: operations. At the
// training encoder (8,8,1008,1008,32) 29 GFLOP and 130 M exponentials (P in
// both kernels) against 33 MB.
//
// bf16 at head dims 16 and 32 (tensor cores): K2's body. mma.sync.m16n8k16
// with the A operand held in registers (Q and g in the dQ kernel, K and V in
// the dK/dV kernel), B from swizzled rows by ldmatrix, and a product's
// float32 accumulator rounded to bf16 and repacked in registers as the A
// operand of the next (dS for dS K; P and dS for P^T g and dS^T Q). The
// dK/dV kernel computes S^T = K Q^T, so that P^T comes out in the layout
// pack_p turns into an A operand. At head dims 64, 128, 192 and 256 the
// pair runs the Hopper bodies of the section after this one (wgmma, TMA),
// on the same scheme with 128-row blocks. float32 keeps a CUDA-core body,
// four threads a row as the forwards' float32 bodies.

static_assert(kRows == kFlashWarps * kWarpRows && kRows == kTileKeys && kRows == kFlashKeys,
              "the backward's row and key tiles are 64 in both types");

// The bf16 pair of a fragment register as floats (lower column in .x).
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// How the bf16 pair splits its work at head dim D. Above 64 (no longer
// instantiated: the Hopper bodies take 64 and 128) it ran two blocks a tile
// (grid z), each half the head dim of its outputs, in 32-row steps. At 16
// and 32 it is one block a tile in one 64-row step; the bodies and their
// helpers keep this text, so that they compile to the code DETR's path has
// been measured with.
template <int D> struct Backward {
  static constexpr int kHalves = D > 64 ? 2 : 1;  // blocks a tile (grid z), each DO output columns
  static constexpr int DO = D / kHalves;
  static constexpr int kSub = D > 64 ? 32 : 64;  // rows of a ring tile a step takes (one step, not unrolled)
  static constexpr int N = kSub / 8;             // score tile: N m16n8 accumulators
};

// ------------------------------------------------------------------ dQ, bf16
template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, D <= 32 ? 3 : 2)
attention_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     const bf16* __restrict__ out, const float* __restrict__ lse,
                     const bf16* __restrict__ g, bf16* __restrict__ dq,
                     float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq,
                     int Lk, int Lq_pad, float scale_log2, float scale) {
  using R = Ring<D, 1>;
  extern __shared__ __align__(128) uint8_t smem_kv[];
  const uint32_t ring = smem_u32(smem_kv);
  auto ring_bias = [&](int s) { return R::vec(smem_kv, 0, s); };

  const int bh = blockIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bf16* k_bh = k + (size_t)bh * Lk * D;
  const bf16* v_bh = v + (size_t)bh * Lk * D;
  const int tiles = (Lk + kTileKeys - 1) / kTileKeys;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const float scale_p = all_masked ? 0.f : scale_log2;
  const int tid = threadIdx.x;

  auto issue = [&](int t) {  // as K2
    if (t < tiles) {
      const int k0 = t * kTileKeys, n = min(kTileKeys, Lk - k0);
      stage_async<D>(R::a(ring, t % kFlashStages), k_bh + (size_t)k0 * D, n, kTileKeys);
      stage_async<D>(R::b(ring, t % kFlashStages), v_bh + (size_t)k0 * D, n, kTileKeys);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kFlashStages - 1; ++t) {
    issue(t);
    if (tid < kTileKeys) ring_bias(t)[tid] = key_bias(mask_b, t * kTileKeys + tid, Lk, all_masked);
  }

  const int row0 = blockIdx.y * kFlashWarps * kWarpRows + tid / 32 * kWarpRows;
  const bool live = row0 < Lq;
  const size_t q_off = (size_t)bh * Lq * D;
  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_q<D>(q + q_off, row0, Lq, qa);
  load_q<D>(g + q_off, row0, Lq, ga);

  // D and lse in base 2 of the warp's rows g and g + 8, into registers and
  // the scratch. Rows past Lq have g = 0, so D = 0, and lse2 = +inf.
  const int quad_row = (tid % 32) / 4;
  float dsum[2], lse2[2];
  {
    uint32_t oa[D / 16][4];
    load_q<D>(out + q_off, row0, Lq, oa);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // registers 0, 2 hold row g; 1, 3 row g + 8
        const float2 a = unpack_bf16(ga[kk][j]), b = unpack_bf16(oa[kk][j]);
        part[j % 2] = fmaf(a.y, b.y, fmaf(a.x, b.x, part[j % 2]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + quad_row + 8 * r;
      dsum[r] = quad_sum(part[r]);
      lse2[r] = row < Lq ? lse[(size_t)bh * Lq + row] * kLog2e : INFINITY;
      if (tid % 4 == 0 && blockIdx.z == 0) {
        lse2_pad[(size_t)bh * Lq_pad + row] = lse2[r];
        dsum_pad[(size_t)bh * Lq_pad + row] = dsum[r];
      }
    }
  }

  using W = Backward<D>;
  constexpr int N = W::N;
  float o[W::DO / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFlashStages - 2>();  // tile t has landed
    __syncthreads();                    // ... for every thread; tile t - 1's slot is free
    const int next = t + kFlashStages - 1;
    issue(next);
    const float next_bias =
        tid < kTileKeys ? key_bias(mask_b, next * kTileKeys + tid, Lk, all_masked) : 0.f;

    if (live) {
      const int slot = t % kFlashStages;
#pragma unroll 1
      for (int kb = 0; kb < kTileKeys; kb += W::kSub) {
        float s[N][4], dp[N][4];
        score_tile<D, N>(qa, R::a(ring, slot), ring_bias(slot), kb, scale_p, s);
        product_tile<D, N>(ga, R::b(ring, slot), kb, dp);
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = ex2(s[n][e] - lse2[e / 2]) * (dp[n][e] - dsum[e / 2]);
        uint32_t da[N / 2][4];
        pack_p<N>(s, da);
        pv_tile<D, N / 2, W::DO>(da, R::a(ring, slot), kb, o, blockIdx.z * W::DO / 8);  // dQ += dS K
      }
    }
    if (tid < kTileKeys) ring_bias(next % kFlashStages)[tid] = next_bias;
  }
  cp_async_wait<0>();
  if (!live) return;
  const float sc[2] = {scale, scale};
  store_o<D, W::DO>(o, sc, dq + q_off, row0, Lq, blockIdx.z * W::DO);
}

// ---------------------------------------------------------------- dK/dV, bf16
template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, D <= 32 ? 3 : 2)
attention_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                       const bf16* __restrict__ g, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       const float* __restrict__ lse2_pad, const float* __restrict__ dsum_pad,
                       int H, int Lq, int Lk, int Lq_pad, float scale_log2, float scale) {
  using R = Ring<D, 2>;
  extern __shared__ __align__(128) uint8_t smem_kv[];
  const uint32_t ring = smem_u32(smem_kv);
  auto ring_lse2 = [&](int s) { return R::vec(smem_kv, 0, s); };
  auto ring_dsum = [&](int s) { return R::vec(smem_kv, 1, s); };

  const int bh = blockIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const float scale_p = all_masked ? 0.f : scale_log2;
  const int tid = threadIdx.x;
  const size_t q_off = (size_t)bh * Lq * D, pad_off = (size_t)bh * Lq_pad;
  const int tiles = Lq_pad / kTileKeys;

  // Start query tile t's copies: Q and g rows (zero past Lq), and its lse2
  // and D, 16 chunks of 16 bytes each (the scratch is padded to the tile).
  auto issue = [&](int t) {
    if (t < tiles) {
      const int r0 = t * kTileKeys, n = min(kTileKeys, Lq - r0), slot = t % kFlashStages;
      stage_async<D>(R::a(ring, slot), q + q_off + (size_t)r0 * D, n, kTileKeys);
      stage_async<D>(R::b(ring, slot), g + q_off + (size_t)r0 * D, n, kTileKeys);
      constexpr int kChunks = kTileKeys / 4;
      if (tid < 2 * kChunks) {
        const int c = 4 * (tid % kChunks);
        const bool is_lse = tid < kChunks;
        cp_async16(smem_u32((is_lse ? ring_lse2(slot) : ring_dsum(slot)) + c),
                   (is_lse ? lse2_pad : dsum_pad) + pad_off + r0 + c, true);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kFlashStages - 1; ++t) issue(t);

  const int key0 = blockIdx.y * kFlashWarps * kWarpRows + tid / 32 * kWarpRows;
  const bool live = key0 < Lk;
  const size_t kv_off = (size_t)bh * Lk * D;
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_q<D>(k + kv_off, key0, Lk, ka);
  load_q<D>(v + kv_off, key0, Lk, va);
  const int quad_row = (tid % 32) / 4, t4 = tid % 4;
  const float kbias[2] = {key_bias(mask_b, key0 + quad_row, Lk, all_masked),
                          key_bias(mask_b, key0 + quad_row + 8, Lk, all_masked)};

  using W = Backward<D>;
  constexpr int N = W::N;
  const int c0 = blockIdx.z * W::DO / 8;  // this block's first output column chunk
  float dk_acc[W::DO / 8][4] = {}, dv_acc[W::DO / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFlashStages - 2>();  // tile t has landed
    __syncthreads();                    // ... for every thread; tile t - 1's slot is free
    issue(t + kFlashStages - 1);
    if (live) {
      const int slot = t % kFlashStages;
      const uint32_t sq = R::a(ring, slot), sg = R::b(ring, slot);
#pragma unroll 1
      for (int qb = 0; qb < kTileKeys; qb += W::kSub) {
        float p[N][4], ds[N][4];
        product_tile<D, N>(ka, sq, qb, p);   // S^T (unscaled): the warp's keys x the step's queries
        product_tile<D, N>(va, sg, qb, ds);  // dP^T = V g^T
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(ring_lse2(slot) + qb + 8 * n + 2 * t4);
          const float2 dd = *reinterpret_cast<const float2*>(ring_dsum(slot) + qb + 8 * n + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // e % 2: query 2 t4 + e % 2; e / 2: key row g or g + 8
            p[n][e] = ex2(fmaf(p[n][e], scale_p, kbias[e / 2]) - (e % 2 ? l2.y : l2.x));
            ds[n][e] = p[n][e] * (ds[n][e] - (e % 2 ? dd.y : dd.x));
          }
        }
        uint32_t pa[N / 2][4];
        pack_p<N>(p, pa);
        pv_tile<D, N / 2, W::DO>(pa, sg, qb, dv_acc, c0);  // dV += P^T g
        pack_p<N>(ds, pa);
        pv_tile<D, N / 2, W::DO>(pa, sq, qb, dk_acc, c0);  // dK += dS^T Q
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  const float sc[2] = {scale, scale}, one[2] = {1.f, 1.f};
  store_o<D, W::DO>(dk_acc, sc, dk + kv_off, key0, Lk, c0 * 8);
  store_o<D, W::DO>(dv_acc, one, dv + kv_off, key0, Lk, c0 * 8);
}

// ======================= bf16 at head dims 64, 128, 192, 256 (wgmma, TMA)
// K2 and B.4's pair at head dims 64 and 128 (and those padded to them), on
// Hopper's warpgroup products, in the shape FlashAttention-3 published: a
// block is two consumer warpgroups of 64 rows each (128 query rows; the
// dK/dV kernel 128 keys) and a producer warp.
//  * The producer warp keeps the TMA busy: the block's fixed tiles (K2's Q;
//    the dQ kernel's Q and g; the dK/dV kernel's K and V) once, then the
//    streamed tiles through a ring of two stages with a full and an empty
//    mbarrier each. The 3-D tensor maps (D, L, B*H) zero-fill rows
//    past L, so a tile that runs past the sequence never reads the next
//    head; keys past Lk also get a -inf bias. A bf16 row of 64 values is one
//    128-byte panel; at D = 128 a tile is two panels of 64 columns.
//  * The producer is one warp after the consumers' two warpgroups (288
//    threads). An SM quadrant then holds three of a block's warps, so a
//    thread may use 168 registers; a producer warpgroup that hands its
//    registers to the consumers by setmaxnreg left ptxas's allocation at
//    168 all the same (nvcc -Xptxas -v, the same spills at 200, 232 and
//    240), so the bodies are sized to 168: K2 keeps 128-key score tiles and
//    one tile's P.V at a time, the pair 64-row tiles, and the dK/dV kernel
//    accumulates 64 columns of dK and dV a block (grid z; at D = 128 its two
//    blocks both compute S^T and dP^T, 2 of the pair's 7 products twice).
//  * S = Q K^T (and dP = g V^T) is wgmma.m64nNk16 with both operands read
//    from shared memory through descriptors (the TMA's 128-byte swizzle,
//    K-major). The score tile's accumulator layout is mma.sync's, so
//    softmax, bias and the online max and sum are K2's; P (dS) is rounded to
//    bf16 and repacked in registers as the A operand of the next wgmma, with
//    V (K, g, Q) as B read MN-major from the same tiles: P never goes
//    through shared memory.
//  * The pair keeps FlashAttention-2's split (dQ over query blocks, then
//    dK/dV over key blocks, no atomics); the dK/dV kernel computes S^T =
//    K Q^T and dP^T = V g^T, so that P^T and dS^T land in registers as the A
//    operands of dV += P^T g and dK += dS^T Q. Its lse2 / D vectors come by
//    bulk copy from the dQ kernel's scratch, whose rows are padded to 128.
//  * What bounds them: K2 at ViT-base/16's (8, 12, 3681, 3681, 64) does
//    333 GFLOP (0.337 ms at 989 TFLOP/s) and 1.3 G exponentials, which the
//    SFUs issue at 16 an SM a clock (about 0.35 ms at 1.755 GHz): the
//    products and the softmax each take about the bound, and the two
//    consumer warpgroups of a block overlap one's softmax with the other's
//    products only as far as they drift apart.
//  * Head dims 192 and 256 (bf16 K2 and the pair above 128, and those
//    padded to them; the VITW DETR's heads of 256). A warpgroup's 64 x D
//    output (K2) or dQ accumulator is D / 2 floats a thread, which with a
//    score tile is over the 168 registers of a 288-thread block. So K2 and
//    the dQ kernel take bodies of their own there, without the producer
//    warp (attention_flash_wgmma_inline, attention_bwd_dq_wgmma_inline): a
//    block is the two consumer warpgroups alone (256 threads, two warps a
//    quadrant, 255 registers a thread), and warp 0 does the producer's work
//    in line, starting tile t + 2's loads into the stage that tile t freed
//    once the block has consumed it (a warpgroup runs at most a tile ahead
//    of the other). The launchers choose by head dim (WGMMA_INLINE_ABOVE).
//    The dK/dV kernel keeps its producer warp and its 64-column blocks (3 or 4
//    on grid z, each recomputing S^T and dP^T: 13 products of the pair at
//    D 256 where 5 would do). P.V and dQ += dS K run one 64-column panel a
//    wgmma (m64n64k16). Shared memory takes 64-key tiles in K2, and at
//    D 256 32-row tiles in the pair's rings (Gmma<32>), so that each
//    layout fits the 227 KB of a block with two stages.
constexpr int kWgThreads = 128;                                     // a warpgroup
constexpr int kWgConsumers = 2;                                     // consumer warpgroups a block
constexpr int kWgConsumerThreads = kWgThreads * kWgConsumers;
constexpr int kWgBlockThreads = kWgConsumerThreads + 32;           // and one producer warp
constexpr int kWgRows = 64 * kWgConsumers;                         // query rows (dK/dV: keys) a block
constexpr int kPanel = 64;                                          // bf16 columns of a 128-byte panel
// K2 and the dQ kernel above this head dim run the in-line bodies; the
// in-line bodies are generic over D, and -DWGMMA_INLINE_ABOVE=0 builds a
// variant of the library that runs them at 64 and 128 too, to time them
// against the producer-warp bodies (attention_kernel_bench --define).
#ifndef WGMMA_INLINE_ABOVE
#define WGMMA_INLINE_ABOVE 128
#endif

// Descriptor of the k16 step kk of rows [r0, r0 + 64) of an R-row tile
// (K-major: the step runs along the rows' D values; panel kk / 4).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return gmma_desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32, 16, 1024);
}
// Descriptor of rows [16 kk, 16 kk + 16) of an R-row tile as the depth of a
// product over all its D columns (MN-major; the panels R * 128 bytes apart).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, R * 128, 1024);
}

// Round a score tile's accumulator (N columns, mma.sync's layout) to bf16
// and repack it as the A operands of its N / 16 k16 steps.
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// K2's online softmax of one tile's N scores in sc (mma.sync's layout):
// s * scale + the keys' bias; the rows' new max m (base 2) and sum l; sc
// becomes p = 2^(s - m), and alpha the factor the rows' earlier output takes.
template <int N>
__device__ __forceinline__ void flash_softmax(float (&sc)[N / 2], const float* bias, float scale, float (&m)[2],
                                              float (&l)[2], float (&alpha)[2]) {
  const int t4 = threadIdx.x % 4;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[4 * n + e] = fmaf(sc[4 * n + e], scale, e % 2 ? bb.y : bb.x);
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    mu[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - mu[r]);  // 0 while m is -inf
    l[r] *= alpha[r];
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    sc[i] = ex2(sc[i] - mu[(i / 2) % 2]);
    l[(i / 2) % 2] += sc[i];
  }
}

// Write a warp's 16 rows (from row0) of a 64 x N accumulator times f[r]
// into columns [col0, col0 + N) of bf16 rows of D values; rows at or past L
// are skipped.
template <int D, int N = D>
__device__ __forceinline__ void store_acc(const float (&a)[N / 2], const float (&f)[2], bf16* x_bh, int row0,
                                          int L, int col0 = 0) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= L) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(x_bh + (size_t)row * D + col0);
#pragma unroll
    for (int dn = 0; dn < N / 8; ++dn) dst[4 * dn + t] = pack_bf16(a[4 * dn + 2 * r] * f[r], a[4 * dn + 2 * r + 1] * f[r]);
  }
}

// Shared memory of the three kernels, byte offsets from a 1024-byte
// aligned base: the fixed tiles (two of kWgRows rows; K2 one), the ring's
// kStages stages of two tiles of kRing rows, its float vectors (K2 and dQ:
// the key bias; dK/dV: lse2 and D) and the mbarriers (fixed, full[s],
// empty[s]). kSmem counts the 1024 bytes the base may need.
template <int D, int kFixed, int kRing, int kVecs> struct WgLayout {
  static constexpr int kStages = 2;
  static constexpr uint32_t kTile = kRing * D * 2;
  static constexpr uint32_t kFix = kWgRows * D * 2;
  static constexpr uint32_t kA = kFixed * kFix;                     // the ring's first tiles
  static constexpr uint32_t kB = kA + kStages * kTile;            // and second
  static constexpr uint32_t kVec = kB + kStages * kTile;          // kVecs x kRing floats a stage
  static constexpr uint32_t kBar = kVec + kStages * kVecs * kRing * 4;
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kA % 1024 == 0 && kTile % 1024 == 0, "swizzle atoms are 1024-byte aligned");
  static_assert(kSmem <= 232448, "a block's shared memory");
};
// Keys (K2, dQ) or query rows (dK/dV) of a ring tile.
template <int D> struct WgTiles {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256, "the wgmma bodies take head dims 64 to 256");
  static constexpr int kFlashKeys = D <= 128 ? 128 : 64;
  static constexpr int kDqKeys = D == 256 ? 32 : 64;
  static constexpr int kDkdvRows = D == 256 ? 32 : 64;
};
template <int D> using FlashLayout = WgLayout<D, 1, WgTiles<D>::kFlashKeys, 1>;
template <int D> using DqLayout = WgLayout<D, 2, WgTiles<D>::kDqKeys, 1>;
template <int D> using DkdvLayout = WgLayout<D, 2, WgTiles<D>::kDkdvRows, 2>;

// The block's shared base, 1024-byte aligned, as a shared address and as a
// generic pointer.
struct WgSmem {
  uint32_t base;
  uint8_t* ptr;  // the same byte, generic
  __device__ __forceinline__ explicit WgSmem(uint8_t* raw) {
    base = (smem_u32(raw) + 1023) & ~1023u;
    ptr = raw + (base - smem_u32(raw));
  }
};

// ------------------------------------------------------------- K2, wgmma
template <int D>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
attention_flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                      bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                      float scale_log2) {
  using L = FlashLayout<D>;
  constexpr int kKeys = WgTiles<D>::kFlashKeys;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_q = sm.base, bar_q = sm.base + L::kBar;
  auto s_k = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_v = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto bias = [&](int s) { return reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = blockIdx.x * kWgRows, bh = blockIdx.y, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes, each after its bias values
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the init

  if (tid >= kWgConsumerThreads) {  // the producer warp
    const int lane = tid - kWgConsumerThreads;
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kFix);
#pragma unroll
      for (int h = 0; h < D / kPanel; ++h) tma_load(s_q + h * kWgRows * 128, &tq, h * kPanel, q0, bh, bar_q);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % L::kStages;
      if (t >= L::kStages) mbar_wait(empty(s), (t / L::kStages - 1) & 1);
      for (int j = lane; j < kKeys; j += 32) bias(s)[j] = key_bias(mask_b, t * kKeys + j, Lk, all_masked);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * L::kTile);
#pragma unroll
        for (int h = 0; h < D / kPanel; ++h) {
          tma_load(s_k(s) + h * kKeys * 128, &tk, h * kPanel, t * kKeys, bh, full(s));
          tma_load(s_v(s) + h * kKeys * 128, &tv, h * kPanel, t * kKeys, bh, full(s));
        }
      } else {
        mbar_arrive(full(s));
      }
    }
  } else {  // the consumers
    const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
    const float scale = all_masked ? 0.f : scale_log2;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    mbar_wait(bar_q, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % L::kStages;
      mbar_wait(full(s), (t / L::kStages) & 1);
      float sc[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Gmma<kKeys>::template ss<0>(sc, desc_k<kWgRows>(s_q, 64 * wc, kk), desc_k<kKeys>(s_k(s), 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      flash_softmax<kKeys>(sc, bias(s), scale, m, l, alpha);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * dn + e] *= alpha[e / 2];
      uint32_t pa[kKeys / 16][4];
      pack_a<kKeys>(sc, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) Gmma<D>::template rs<1>(o, pa[kk], desc_mn<kKeys>(s_v(s), kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(s));
    }
    const int row0 = q0 + 64 * wc + 16 * w;
    const float sum[2] = {quad_sum(l[0]), quad_sum(l[1])};
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    store_acc<D>(o, inv, out + (size_t)bh * Lq * D, row0, Lq);
    if (lse != nullptr && t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + lane / 4 + 8 * r;
        if (row < Lq) lse[(size_t)bh * Lq + row] = (m[r] + log2f(sum[r])) * kLn2;
      }
    }
  }
}

// -------------------------------------------------------------- dQ, wgmma
template <int D>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const uint8_t* __restrict__ mask, const bf16* __restrict__ out,
                       const float* __restrict__ lse, const bf16* __restrict__ g, bf16* __restrict__ dq,
                       float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq, int Lk,
                       int Lq_pad, float scale_log2, float scale) {
  using L = DqLayout<D>;
  constexpr int kKeys = WgTiles<D>::kDqKeys;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_q = sm.base, s_g = sm.base + L::kFix, bar_q = sm.base + L::kBar;
  auto s_k = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_v = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto bias = [&](int s) { return reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = blockIdx.x * kWgRows, bh = blockIdx.y, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);

  if (tid >= kWgConsumerThreads) {  // the producer warp, as K2's
    const int lane = tid - kWgConsumerThreads;
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * L::kFix);
#pragma unroll
      for (int h = 0; h < D / kPanel; ++h) {
        tma_load(s_q + h * kWgRows * 128, &tq, h * kPanel, q0, bh, bar_q);
        tma_load(s_g + h * kWgRows * 128, &tg, h * kPanel, q0, bh, bar_q);
      }
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % L::kStages;
      if (t >= L::kStages) mbar_wait(empty(s), (t / L::kStages - 1) & 1);
      for (int j = lane; j < kKeys; j += 32) bias(s)[j] = key_bias(mask_b, t * kKeys + j, Lk, all_masked);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * L::kTile);
#pragma unroll
        for (int h = 0; h < D / kPanel; ++h) {
          tma_load(s_k(s) + h * kKeys * 128, &tk, h * kPanel, t * kKeys, bh, full(s));
          tma_load(s_v(s) + h * kKeys * 128, &tv, h * kPanel, t * kKeys, bh, full(s));
        }
      } else {
        mbar_arrive(full(s));
      }
    }
  } else {  // the consumers
    const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
    const float scale_p = all_masked ? 0.f : scale_log2;
    const int row0 = q0 + 64 * wc + 16 * w;
    const size_t q_off = (size_t)bh * Lq * D;
    // D and lse in base 2 of the warp's rows lane / 4 and + 8, into registers
    // and the scratch. Rows past Lq have g = 0, so D = 0, and lse2 = +inf.
    float dsum[2], lse2[2];
    {
      uint32_t ga[D / 16][4], oa[D / 16][4];
      load_q<D>(g + q_off, row0, Lq, ga);
      load_q<D>(out + q_off, row0, Lq, oa);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // registers 0, 2 hold row lane / 4; 1, 3 row lane / 4 + 8
          const float2 a = unpack_bf16(ga[kk][j]), b = unpack_bf16(oa[kk][j]);
          part[j % 2] = fmaf(a.y, b.y, fmaf(a.x, b.x, part[j % 2]));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + lane / 4 + 8 * r;
        dsum[r] = quad_sum(part[r]);
        lse2[r] = row < Lq ? lse[(size_t)bh * Lq + row] * kLog2e : INFINITY;
        if (t4 == 0) {
          lse2_pad[(size_t)bh * Lq_pad + row] = lse2[r];
          dsum_pad[(size_t)bh * Lq_pad + row] = dsum[r];
        }
      }
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(bar_q, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % L::kStages;
      mbar_wait(full(s), (t / L::kStages) & 1);
      float sc[kKeys / 2], dp[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Gmma<kKeys>::template ss<0>(sc, desc_k<kWgRows>(s_q, 64 * wc, kk), desc_k<kKeys>(s_k(s), 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Gmma<kKeys>::template ss<0>(dp, desc_k<kWgRows>(s_g, 64 * wc, kk), desc_k<kKeys>(s_v(s), 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const float* b = bias(s);
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(b + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          sc[i] = ex2(fmaf(sc[i], scale_p, e % 2 ? bb.y : bb.x) - lse2[e / 2]) * (dp[i] - dsum[e / 2]);
        }
      }
      uint32_t da[kKeys / 16][4];
      pack_a<kKeys>(sc, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) Gmma<D>::template rs<1>(acc, da[kk], desc_mn<kKeys>(s_k(s), kk));
      wgmma_commit();  // dQ += dS K
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }
    const float sc2[2] = {scale, scale};
    store_acc<D>(acc, sc2, dq + q_off, row0, Lq);
  }
}

// ----------------------------------------------------------- dK/dV, wgmma
template <int D>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
attention_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                         const uint8_t* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const float* __restrict__ lse2_pad, const float* __restrict__ dsum_pad, int H,
                         int Lq, int Lk, int Lq_pad, float scale_log2, float scale) {
  using L = DkdvLayout<D>;
  constexpr int kQRows = WgTiles<D>::kDkdvRows;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_k = sm.base, s_v = sm.base + L::kFix, bar_kv = sm.base + L::kBar;
  auto s_q = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_g = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto vec = [&](int s) { return sm.base + L::kVec + s * 2 * kQRows * 4; };  // lse2, then D
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + L::kStages + s); };

  const int k0 = blockIdx.x * kWgRows, bh = blockIdx.y, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = Lq_pad / kQRows;
  const size_t pad_off = (size_t)bh * Lq_pad;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);

  if (tid >= kWgConsumerThreads) {  // the producer warp: K and V once, then Q, g, lse2 and D a query tile
    const int lane = tid - kWgConsumerThreads;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kFix);
#pragma unroll
      for (int h = 0; h < D / kPanel; ++h) {
        tma_load(s_k + h * kWgRows * 128, &tk, h * kPanel, k0, bh, bar_kv);
        tma_load(s_v + h * kWgRows * 128, &tv, h * kPanel, k0, bh, bar_kv);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % L::kStages, r0 = t * kQRows;
        if (t >= L::kStages) mbar_wait(empty(s), (t / L::kStages - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kTile + 2 * kQRows * 4);
#pragma unroll
        for (int h = 0; h < D / kPanel; ++h) {
          tma_load(s_q(s) + h * kQRows * 128, &tq, h * kPanel, r0, bh, full(s));
          tma_load(s_g(s) + h * kQRows * 128, &tg, h * kPanel, r0, bh, full(s));
        }
        bulk_load(vec(s), lse2_pad + pad_off + r0, kQRows * 4, full(s));
        bulk_load(vec(s) + kQRows * 4, dsum_pad + pad_off + r0, kQRows * 4, full(s));
      }
    }
  } else {  // the consumers
    const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
    const float scale_p = all_masked ? 0.f : scale_log2;
    const int key0 = k0 + 64 * wc + 16 * w;
    const float kbias[2] = {key_bias(mask_b, key0 + lane / 4, Lk, all_masked),
                            key_bias(mask_b, key0 + lane / 4 + 8, Lk, all_masked)};
    const int c0 = blockIdx.z * kPanel;  // this block's 64 columns of dK and dV
    float dka[kPanel / 2], dva[kPanel / 2];
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(bar_kv, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % L::kStages;
      mbar_wait(full(s), (t / L::kStages) & 1);
      float p[kQRows / 2], ds[kQRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T (unscaled): this warpgroup's keys x the tile's queries
        Gmma<kQRows>::template ss<0>(p, desc_k<kWgRows>(s_k, 64 * wc, kk), desc_k<kQRows>(s_q(s), 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V g^T
        Gmma<kQRows>::template ss<0>(ds, desc_k<kWgRows>(s_v, 64 * wc, kk), desc_k<kQRows>(s_g(s), 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p);
      fence_regs(ds);
      const float* l2 = reinterpret_cast<const float*>(sm.ptr + (vec(s) - sm.base));
      const float* dd = l2 + kQRows;
#pragma unroll
      for (int n = 0; n < kQRows / 8; ++n) {
        const float2 l2p = *reinterpret_cast<const float2*>(l2 + 8 * n + 2 * t4);
        const float2 ddp = *reinterpret_cast<const float2*>(dd + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // e % 2: query 8n + 2 t4 + e % 2; e / 2: key row lane / 4 or + 8
          const int i = 4 * n + e;
          p[i] = ex2(fmaf(p[i], scale_p, kbias[e / 2]) - (e % 2 ? l2p.y : l2p.x));
          ds[i] = p[i] * (ds[i] - (e % 2 ? ddp.y : ddp.x));
        }
      }
      uint32_t pa[kQRows / 16][4], da[kQRows / 16][4];
      pack_a<kQRows>(p, pa);
      pack_a<kQRows>(ds, da);
      wgmma_fence();
      const uint32_t panel = blockIdx.z * kQRows * 128;  // columns c0.. of the g and Q tiles
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        Gmma<kPanel>::template rs<1>(dva, pa[kk], desc_mn<kQRows>(s_g(s) + panel, kk));
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        Gmma<kPanel>::template rs<1>(dka, da[kk], desc_mn<kQRows>(s_q(s) + panel, kk));
      wgmma_commit();  // dV += P^T g, dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(empty(s));
    }
    const size_t kv_off = (size_t)bh * Lk * D;
    const float sc[2] = {scale, scale}, one[2] = {1.f, 1.f};
    store_acc<D, kPanel>(dka, sc, dk + kv_off, key0, Lk, c0);
    store_acc<D, kPanel>(dva, one, dv + kv_off, key0, Lk, c0);
  }
}

// ------------------------------------------ K2 and dQ at D 192 and 256, wgmma
// The producer's work for ring tile t of K2 or the dQ kernel (layout L,
// kKeys keys a tile), done in line by warp 0 of a 256-thread block: wait
// until tile t - kStages has been consumed, write tile t's key bias, then
// start its K and V loads (lane 0; the other lanes arrive on full once
// their bias values are written).
template <typename L, int D, int kKeys>
__device__ __forceinline__ void load_kv_tile(const WgSmem& sm, int t, int lane, const CUtensorMap& tk,
                                             const CUtensorMap& tv, int bh, const uint8_t* mask_b, int Lk,
                                             bool all_masked) {
  const int s = t % L::kStages;
  const uint32_t full = sm.base + L::kBar + 8 * (1 + s), empty = full + 8 * L::kStages;
  if (t >= L::kStages) mbar_wait(empty, (t / L::kStages - 1) & 1);
  float* bias = reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys;
  for (int j = lane; j < kKeys; j += 32) bias[j] = key_bias(mask_b, t * kKeys + j, Lk, all_masked);
  if (lane == 0) {
    mbar_expect_tx(full, 2 * L::kTile);
#pragma unroll
    for (int h = 0; h < D / kPanel; ++h) {
      tma_load(sm.base + L::kA + s * L::kTile + h * kKeys * 128, &tk, h * kPanel, t * kKeys, bh, full);
      tma_load(sm.base + L::kB + s * L::kTile + h * kKeys * 128, &tv, h * kPanel, t * kKeys, bh, full);
    }
  } else {
    mbar_arrive(full);
  }
}

// K2 at D 192 and 256 (the section's note): attention_flash_wgmma's
// contract and tiles, in a block of the two consumer warpgroups alone, with
// warp 0 as the producer in line and the output accumulator in D / 64
// panels of 64 columns.
template <int D>
__global__ void __launch_bounds__(kWgConsumerThreads, 1)
attention_flash_wgmma_inline(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                             bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                             float scale_log2) {
  using L = FlashLayout<D>;
  constexpr int kKeys = WgTiles<D>::kFlashKeys, kPanels = D / kPanel;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_q = sm.base, bar_q = sm.base + L::kBar;
  auto s_k = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_v = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto bias = [&](int s) { return reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = blockIdx.x * kWgRows, bh = blockIdx.y, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 32);  // warp 0's lanes, each after its bias values
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the init
  if (tid < 32) {  // warp 0: Q, then the ring's first tiles
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kFix);
#pragma unroll
      for (int h = 0; h < kPanels; ++h) tma_load(s_q + h * kWgRows * 128, &tq, h * kPanel, q0, bh, bar_q);
    }
    for (int t = 0; t < min(tiles, L::kStages); ++t)
      load_kv_tile<L, D, kKeys>(sm, t, tid, tk, tv, bh, mask_b, Lk, all_masked);
    __syncwarp();
  }
  const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
  const float scale = all_masked ? 0.f : scale_log2;
  float o[kPanels][kPanel / 2];
#pragma unroll
  for (int h = 0; h < kPanels; ++h)
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) o[h][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  mbar_wait(bar_q, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(full(s), (t / L::kStages) & 1);
    float sc[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Gmma<kKeys>::template ss<0>(sc, desc_k<kWgRows>(s_q, 64 * wc, kk), desc_k<kKeys>(s_k(s), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    flash_softmax<kKeys>(sc, bias(s), scale, m, l, alpha);
#pragma unroll
    for (int h = 0; h < kPanels; ++h)
#pragma unroll
      for (int i = 0; i < kPanel / 2; ++i) o[h][i] *= alpha[(i / 2) % 2];
    uint32_t pa[kKeys / 16][4];
    pack_a<kKeys>(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kPanels; ++h)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        Gmma<kPanel>::template rs<1>(o[h], pa[kk], desc_mn<kKeys>(s_v(s) + h * kKeys * 128, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kPanels; ++h) fence_regs(o[h]);
    mbar_arrive(empty(s));
    if (tid < 32 && t + L::kStages < tiles) {  // warp 0 refills the stage once the block has consumed it
      load_kv_tile<L, D, kKeys>(sm, t + L::kStages, tid, tk, tv, bh, mask_b, Lk, all_masked);
      __syncwarp();
    }
  }
  const int row0 = q0 + 64 * wc + 16 * w;
  const float sum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int h = 0; h < kPanels; ++h) store_acc<D, kPanel>(o[h], inv, out + (size_t)bh * Lq * D, row0, Lq, h * kPanel);
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < Lq) lse[(size_t)bh * Lq + row] = (m[r] + log2f(sum[r])) * kLn2;
    }
  }
}

// The dQ kernel at D 192 and 256: attention_bwd_dq_wgmma's contract and
// tiles (32-key ring tiles at D 256), in a block of the two consumer
// warpgroups alone, warp 0 the producer in line, the dQ accumulator in
// D / 64 panels.
template <int D>
__global__ void __launch_bounds__(kWgConsumerThreads, 1)
attention_bwd_dq_wgmma_inline(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                              const uint8_t* __restrict__ mask, const bf16* __restrict__ out,
                              const float* __restrict__ lse, const bf16* __restrict__ g, bf16* __restrict__ dq,
                              float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq, int Lk,
                              int Lq_pad, float scale_log2, float scale) {
  using L = DqLayout<D>;
  constexpr int kKeys = WgTiles<D>::kDqKeys, kPanels = D / kPanel;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_q = sm.base, s_g = sm.base + L::kFix, bar_q = sm.base + L::kBar;
  auto s_k = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_v = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto bias = [&](int s) { return reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = blockIdx.x * kWgRows, bh = blockIdx.y, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);
  if (tid < 32) {  // warp 0: Q and g, then the ring's first tiles
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * L::kFix);
#pragma unroll
      for (int h = 0; h < kPanels; ++h) {
        tma_load(s_q + h * kWgRows * 128, &tq, h * kPanel, q0, bh, bar_q);
        tma_load(s_g + h * kWgRows * 128, &tg, h * kPanel, q0, bh, bar_q);
      }
    }
    for (int t = 0; t < min(tiles, L::kStages); ++t)
      load_kv_tile<L, D, kKeys>(sm, t, tid, tk, tv, bh, mask_b, Lk, all_masked);
    __syncwarp();
  }
  const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
  const float scale_p = all_masked ? 0.f : scale_log2;
  const int row0 = q0 + 64 * wc + 16 * w;
  const size_t q_off = (size_t)bh * Lq * D;
  // D and lse in base 2 of the warp's rows, as attention_bwd_dq_wgmma's.
  float dsum[2], lse2[2];
  {
    uint32_t ga[D / 16][4], oa[D / 16][4];
    load_q<D>(g + q_off, row0, Lq, ga);
    load_q<D>(out + q_off, row0, Lq, oa);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = unpack_bf16(ga[kk][j]), b = unpack_bf16(oa[kk][j]);
        part[j % 2] = fmaf(a.y, b.y, fmaf(a.x, b.x, part[j % 2]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      dsum[r] = quad_sum(part[r]);
      lse2[r] = row < Lq ? lse[(size_t)bh * Lq + row] * kLog2e : INFINITY;
      if (t4 == 0) {
        lse2_pad[(size_t)bh * Lq_pad + row] = lse2[r];
        dsum_pad[(size_t)bh * Lq_pad + row] = dsum[r];
      }
    }
  }

  float acc[kPanels][kPanel / 2];
#pragma unroll
  for (int h = 0; h < kPanels; ++h)
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) acc[h][i] = 0.f;
  mbar_wait(bar_q, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(full(s), (t / L::kStages) & 1);
    float sc[kKeys / 2], dp[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Gmma<kKeys>::template ss<0>(sc, desc_k<kWgRows>(s_q, 64 * wc, kk), desc_k<kKeys>(s_k(s), 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Gmma<kKeys>::template ss<0>(dp, desc_k<kWgRows>(s_g, 64 * wc, kk), desc_k<kKeys>(s_v(s), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const float* b = bias(s);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        sc[i] = ex2(fmaf(sc[i], scale_p, e % 2 ? bb.y : bb.x) - lse2[e / 2]) * (dp[i] - dsum[e / 2]);
      }
    }
    uint32_t da[kKeys / 16][4];
    pack_a<kKeys>(sc, da);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kPanels; ++h)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        Gmma<kPanel>::template rs<1>(acc[h], da[kk], desc_mn<kKeys>(s_k(s) + h * kKeys * 128, kk));
    wgmma_commit();  // dQ += dS K
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kPanels; ++h) fence_regs(acc[h]);
    mbar_arrive(empty(s));
    if (tid < 32 && t + L::kStages < tiles) {
      load_kv_tile<L, D, kKeys>(sm, t + L::kStages, tid, tk, tv, bh, mask_b, Lk, all_masked);
      __syncwarp();
    }
  }
  const float sc2[2] = {scale, scale};
#pragma unroll
  for (int h = 0; h < kPanels; ++h) store_acc<D, kPanel>(acc[h], sc2, dq + q_off, row0, Lq, h * kPanel);
}

// --------------------------------------------------------------- dQ, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ mask,
                        const float* __restrict__ out, const float* __restrict__ lse,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq,
                        int Lk, int Lq_pad, float scale_log2, float scale) {
  __shared__ __align__(16) float sk[kFlashKeys * D];
  __shared__ __align__(16) float sv[kFlashKeys * D];
  __shared__ uint8_t smask[kFlashKeys];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const bool live = row < nq;
  const size_t q_row = (size_t)bh * Lq + q0 + (live ? row : 0);
  float qf[D], gf[D];
  load_query<D>(q + q_row * D, qf);
  load_query<D>(g + q_row * D, gf);
  float dsum = 0.f;
  {
    float of[D];
    load_query<D>(out + q_row * D, of);
#pragma unroll
    for (int d = 0; d < D; ++d) dsum = fmaf(gf[d], of[d], dsum);
  }
  if (!live) dsum = 0.f;
  const float lse2 = live ? lse[q_row] * kLog2e : INFINITY;
  if (split == 0) {
    lse2_pad[(size_t)bh * Lq_pad + q0 + row] = lse2;
    dsum_pad[(size_t)bh * Lq_pad + q0 + row] = dsum;
  }

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
    for (int j = split; j < nk; j += kSplit) {
      if (!all_masked && !smask[j]) continue;
      const float s = all_masked ? 0.f : dot_row<D>(sk, j, qf) * scale_log2;
      const float ds = exp2f(s - lse2) * (dot_row<D>(sv, j, gf) - dsum);
      axpy_row<D>(sk, j, ds, acc);
    }
  }
  write_row<D>(acc, scale, dq + ((size_t)bh * Lq + q0 + row) * D, split, live);
}

// ------------------------------------------------------------ dK/dV, float32
// A key's four threads split the head dim, not the queries: each keeps a
// quarter of the key's K and V rows and of both accumulators (D/4 values
// each, 64 floats a thread at D = 64 instead of 4 D, which spilled), takes
// its part of each dot product over the query rows of the tile, and the quad
// sums the parts with two shuffles. The four threads of a warp that read one
// query row read four different chunks of it: a broadcast, no bank conflict.
template <int D>
__device__ __forceinline__ float dot_slice(const float* rows, int i, int split, const float* x) {
  using L = Layout<D>;
  constexpr int kC = L::kChunks / kSplit;
  const uint4* r = reinterpret_cast<const uint4*>(rows) + i * L::kChunks;
  float acc = 0.f;
#pragma unroll
  for (int cc = 0; cc < kC; ++cc) {
    float y[kVec];
    unpack(r[L::chunk(i, split * kC + cc)], y);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(x[cc * kVec + e], y[e], acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy_slice(const float* rows, int i, int split, float p, float* acc) {
  using L = Layout<D>;
  constexpr int kC = L::kChunks / kSplit;
  const uint4* r = reinterpret_cast<const uint4*>(rows) + i * L::kChunks;
#pragma unroll
  for (int cc = 0; cc < kC; ++cc) {
    float y[kVec];
    unpack(r[L::chunk(i, split * kC + cc)], y);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[cc * kVec + e] = fmaf(p, y[e], acc[cc * kVec + e]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const uint8_t* __restrict__ mask,
                          const float* __restrict__ g, float* __restrict__ dk,
                          float* __restrict__ dv, const float* __restrict__ lse2_pad,
                          const float* __restrict__ dsum_pad, int H, int Lq, int Lk, int Lq_pad,
                          float scale_log2, float scale) {
  constexpr int kSlice = D / kSplit;  // head-dim values a thread keeps
  static_assert(kSlice % kVec == 0, "a thread's slice is whole 16-byte chunks");
  // Dynamic (bwd_dkdv_f32_smem_bytes): the two tiles are 64 KB at D = 128.
  extern __shared__ __align__(16) uint8_t smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sg = sq + kRows * D;
  float* slse2 = sg + kRows * D;
  float* sdsum = slse2 + kRows;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kFlashKeys;
  const int nk = min(kFlashKeys, Lk - k0);
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const unsigned quad = 0xfu << (threadIdx.x % 32 / kSplit * kSplit);  // this key's four lanes
  const bool live = row < nk;
  const bool valid = live && (all_masked || mask_b == nullptr || mask_b[k0 + row]);
  const size_t k_row = (size_t)bh * Lk + k0 + (live ? row : 0);
  float kf[kSlice], vf[kSlice];
  {
    const uint4* kr = reinterpret_cast<const uint4*>(k + k_row * D + split * kSlice);
    const uint4* vr = reinterpret_cast<const uint4*>(v + k_row * D + split * kSlice);
#pragma unroll
    for (int cc = 0; cc < kSlice / kVec; ++cc) {
      unpack(kr[cc], kf + cc * kVec);
      unpack(vr[cc], vf + cc * kVec);
    }
  }

  float dk_acc[kSlice], dv_acc[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  for (int r0 = 0; r0 < Lq; r0 += kRows) {
    const int nq = min(kRows, Lq - r0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<D>(sq, q + ((size_t)bh * Lq + r0) * D, nq);
    stage_rows<D>(sg, g + ((size_t)bh * Lq + r0) * D, nq);
    if (threadIdx.x < kRows) {
      slse2[threadIdx.x] = lse2_pad[(size_t)bh * Lq_pad + r0 + threadIdx.x];
      sdsum[threadIdx.x] = dsum_pad[(size_t)bh * Lq_pad + r0 + threadIdx.x];
    }
    __syncthreads();
    if (!valid) continue;  // a masked key gets dK = dV = 0 (its whole quad skips)
    for (int i = 0; i < nq; ++i) {
      float s = dot_slice<D>(sq, i, split, kf), dp = dot_slice<D>(sg, i, split, vf);
      s += __shfl_xor_sync(quad, s, 1);
      dp += __shfl_xor_sync(quad, dp, 1);
      s += __shfl_xor_sync(quad, s, 2);
      dp += __shfl_xor_sync(quad, dp, 2);
      const float p = exp2f((all_masked ? 0.f : s * scale_log2) - slse2[i]);
      axpy_slice<D>(sg, i, split, p, dv_acc);
      axpy_slice<D>(sq, i, split, p * (dp - sdsum[i]), dk_acc);
    }
  }
  if (!live) return;
  const size_t out = ((size_t)bh * Lk + k0 + row) * D + split * kSlice;
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    dk[out + d] = dk_acc[d] * scale;
    dv[out + d] = dv_acc[d];
  }
}


// Sum a dot product's four parts over the quad of a row (quad: its lanes).
__device__ __forceinline__ float quad_total(unsigned quad, float x) {
  x += __shfl_xor_sync(quad, x, 1);
  return x + __shfl_xor_sync(quad, x, 2);
}

// This thread's quarter of a row of D floats from device memory.
template <int D>
__device__ __forceinline__ void load_slice(const float* row, int split, float* x) {
  const uint4* r = reinterpret_cast<const uint4*>(row + split * (D / kSplit));
#pragma unroll
  for (int cc = 0; cc < D / kSplit / kVec; ++cc) unpack(r[cc], x + cc * kVec);
}

template <int D>
__device__ __forceinline__ void store_slice(float* row, int split, const float* x, float mul) {
  float4* r = reinterpret_cast<float4*>(row + split * (D / kSplit));
#pragma unroll
  for (int cc = 0; cc < D / kSplit / kVec; ++cc)
    r[cc] = make_float4(x[4 * cc] * mul, x[4 * cc + 1] * mul, x[4 * cc + 2] * mul, x[4 * cc + 3] * mul);
}

// ---------------------------------------------------- K1, float32, D = 128
// The contract of attention_whole_kv_kernel with the head dim split over a
// row's four threads: every thread of a row walks every key, so the branch
// on the mask is uniform over the warp and the shuffles over the quad.
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_whole_kv_slice(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                         float scale_log2) {
  constexpr int kSlice = D / kSplit;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + (size_t)Lk * D;
  uint8_t* smask = reinterpret_cast<uint8_t*>(sv + (size_t)Lk * D);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  stage_rows<D>(sk, k + kv_off, Lk);
  stage_rows<D>(sv, v + kv_off, Lk);
  stage_mask(smask, mask_b, 0, Lk);
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the staging

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const unsigned quad = 0xfu << (threadIdx.x % 32 / kSplit * kSplit);
  const bool live = row < nq;
  const size_t q_row = (size_t)bh * Lq + q0 + (live ? row : 0);
  float qf[kSlice];
  load_slice<D>(q + q_row * D, split, qf);
  if (!live) return;  // a row's four threads leave together

  // Pass 1: row max and normalizer, online over the keys.
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < Lk; ++j) {
    if (!all_masked && !smask[j]) continue;
    const float dot = quad_total(quad, dot_slice<D>(sk, j, split, qf));
    const float s = all_masked ? 0.f : dot * scale_log2;
    if (s > m) {
      l = l * exp2f(m - s) + 1.f;
      m = s;
    } else {
      l += exp2f(s - m);
    }
  }
  const float inv_l = 1.f / l;
  if (lse != nullptr && split == 0) lse[q_row] = (m + log2f(l)) * kLn2;

  // Pass 2: normalized probabilities times V.
  float acc[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) acc[d] = 0.f;
  for (int j = 0; j < Lk; ++j) {
    if (!all_masked && !smask[j]) continue;
    const float dot = quad_total(quad, dot_slice<D>(sk, j, split, qf));
    const float s = all_masked ? 0.f : dot * scale_log2;
    axpy_slice<D>(sv, j, split, exp2f(s - m) * inv_l, acc);
  }
  store_slice<D>(out + q_row * D, split, acc, 1.f);
}

// ---------------------------------------------------- K2, float32, D = 128
// attention_flash_kernel's contract with the head dim split as above; the
// running max moves key by key, and the output is rescaled only when it
// rises.
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_flash_slice(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                      float scale_log2) {
  constexpr int kSlice = D / kSplit;
  extern __shared__ __align__(16) uint8_t smem[];  // flash_f32_slice_smem_bytes
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kFlashKeys * D;
  uint8_t* smask = reinterpret_cast<uint8_t*>(sv + kFlashKeys * D);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const unsigned quad = 0xfu << (threadIdx.x % 32 / kSplit * kSplit);
  const bool live = row < nq;
  const size_t q_row = (size_t)bh * Lq + q0 + (live ? row : 0);
  float qf[kSlice], acc[kSlice];
  load_slice<D>(q + q_row * D, split, qf);
#pragma unroll
  for (int d = 0; d < kSlice; ++d) acc[d] = 0.f;

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
    const int nk = min(kFlashKeys, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<D>(sk, k + kv_off + (size_t)k0 * D, nk);
    stage_rows<D>(sv, v + kv_off + (size_t)k0 * D, nk);
    stage_mask(smask, mask_b, k0, nk);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nk; ++j) {
      if (!all_masked && !smask[j]) continue;
      const float dot = quad_total(quad, dot_slice<D>(sk, j, split, qf));
      const float s = all_masked ? 0.f : dot * scale_log2;
      float p = 1.f;
      if (s > m) {  // the max rises: rescale what is summed so far (0 while m is -inf)
        const float alpha = exp2f(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kSlice; ++d) acc[d] *= alpha;
        m = s;
      } else {
        p = exp2f(s - m);
      }
      l += p;
      axpy_slice<D>(sv, j, split, p, acc);
    }
  }
  if (!live) return;
  if (lse != nullptr && split == 0) lse[q_row] = (m + log2f(l)) * kLn2;
  store_slice<D>(out + q_row * D, split, acc, 1.f / l);
}

// ---------------------------------------------------- dQ, float32, D = 128
// attention_bwd_dq_kernel's contract with the head dim split as above.
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_slice(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       const float* __restrict__ out, const float* __restrict__ lse,
                       const float* __restrict__ g, float* __restrict__ dq,
                       float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq,
                       int Lk, int Lq_pad, float scale_log2, float scale) {
  constexpr int kSlice = D / kSplit;
  extern __shared__ __align__(16) uint8_t smem[];  // flash_f32_slice_smem_bytes
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kFlashKeys * D;
  uint8_t* smask = reinterpret_cast<uint8_t*>(sv + kFlashKeys * D);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const unsigned quad = 0xfu << (threadIdx.x % 32 / kSplit * kSplit);
  const bool live = row < nq;
  const size_t q_row = (size_t)bh * Lq + q0 + (live ? row : 0);
  float qf[kSlice], gf[kSlice], acc[kSlice];
  load_slice<D>(q + q_row * D, split, qf);
  load_slice<D>(g + q_row * D, split, gf);
  float dsum = 0.f;
  {
    float of[kSlice];
    load_slice<D>(out + q_row * D, split, of);
#pragma unroll
    for (int d = 0; d < kSlice; ++d) dsum = fmaf(gf[d], of[d], dsum);
  }
  dsum = live ? quad_total(quad, dsum) : 0.f;
  const float lse2 = live ? lse[q_row] * kLog2e : INFINITY;
  if (split == 0) {
    lse2_pad[(size_t)bh * Lq_pad + q0 + row] = lse2;
    dsum_pad[(size_t)bh * Lq_pad + q0 + row] = dsum;
  }

#pragma unroll
  for (int d = 0; d < kSlice; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
    const int nk = min(kFlashKeys, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<D>(sk, k + kv_off + (size_t)k0 * D, nk);
    stage_rows<D>(sv, v + kv_off + (size_t)k0 * D, nk);
    stage_mask(smask, mask_b, k0, nk);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nk; ++j) {
      if (!all_masked && !smask[j]) continue;
      const float dot = quad_total(quad, dot_slice<D>(sk, j, split, qf));
      const float dp = quad_total(quad, dot_slice<D>(sv, j, split, gf));
      const float s = all_masked ? 0.f : dot * scale_log2;
      axpy_slice<D>(sk, j, split, exp2f(s - lse2) * (dp - dsum), acc);
    }
  }
  if (live) store_slice<D>(dq + q_row * D, split, acc, scale);
}

// ============================================== head dims above 128 (C.7)
// What reaches these bodies: float32 at every head dim above 128, K1 in
// both types above 128, and bf16 K2 and the pair above 256 (320, ...); bf16
// K2 and the pair at 192 and 256 (and those padded to them) run the wgmma
// bodies above. The float32 and mma.sync bodies keep a row's q (bf16: its Q
// fragments) and its output in registers and, in K1, a head's whole K and V
// in shared memory; above 128 neither fits (K1 at D 256 float32 and 197 keys
// needs 403 KB of K/V, and the bf16 mma bodies already sit at 214-240
// registers at D 128). These bodies take the head dim in chunks instead,
// one template for both types, on the CUDA cores: Q.K^T (and g.V^T) is
// summed over 64-wide chunks of the head dim staged through shared memory
// as float32, and the output columns
// are split over grid z in 128-wide chunks; each z block recomputes the
// scores, the way the D-128 bf16 pair splits its halves. The wrapper pads
// D to a multiple of 64 (kernels/attention.py::kernel_head_dim). A block is
// 64 query rows (the backward's dK/dV: 64 keys) of four threads each; a
// thread holds 16 scores of a 64-key tile (key split + 4m) and 32 output
// columns (column split + 4c of its chunk). Staged rows are padded to 65
// (129) floats so that the four threads of a row, which read four rows of
// the other operand, hit four banks. Rounding follows the mma bodies: K2
// rounds the unnormalised p to T before P.V, K1 (two passes) the
// normalised p; the backward sums in float32 and rounds only its results.
// Bound: operations, on the CUDA cores; they re-read their operands from
// shared memory for every product, and speed is not their aim: no path of
// the repo's models runs them in bf16 (the VITW DETR's heads of 256 take
// the wgmma bodies; its float32 forward runs K1 here).
constexpr int kWideChunk = 64;                 // head-dim columns of one staged chunk
constexpr int kWideOut = 128;                  // output columns of one grid-z block
constexpr int kWideS = kWideChunk + 1;         // staged row stride (floats)
constexpr int kWideO = kWideOut + 1;           // output-chunk row stride (floats)
constexpr int kWideKeys = kFlashKeys / kSplit; // scores a thread keeps (16)
constexpr int kWideCols = kWideOut / kSplit;   // output columns a thread keeps (32)
constexpr int kWideTile = kRows * kWideS;      // floats of one staged 64 x 64 chunk
constexpr int kWideOutTile = kRows * kWideO;   // floats of one staged 64 x 128 chunk

__device__ __forceinline__ float wide_f(float x) { return x; }
__device__ __forceinline__ float wide_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T wide_t(float x);
template <> __device__ __forceinline__ float wide_t<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 wide_t<bf16>(float x) { return __float2bfloat16(x); }

// Rows [0, n) of src (row stride D), columns [c0, c0 + w), as float32 into
// dst (row stride `stride`, kRows rows); zero past n rows and w columns.
template <typename T>
__device__ __forceinline__ void wide_stage(float* dst, int stride, const T* src, int n, int D, int c0,
                                           int w, int cols) {
  for (int idx = threadIdx.x; idx < kRows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx % cols;
    dst[r * stride + c] = (r < n && c < w) ? wide_f(src[(size_t)r * D + c0 + c]) : 0.f;
  }
}

// s[m] += x[row] . y[split + 4m] over one staged chunk (x, y: kWideTile each).
__device__ __forceinline__ void wide_dots(const float* x, int row, const float* y, int split, float* s) {
#pragma unroll 4
  for (int d = 0; d < kWideChunk; ++d) {
    const float a = x[row * kWideS + d];
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) s[m] = fmaf(a, y[(split + kSplit * m) * kWideS + d], s[m]);
  }
}

// acc[c] += sum_j p[row][j] * y[j][split + 4c] over j < n (p: kWideTile,
// y: kWideOutTile), for the first nc of a thread's columns.
__device__ __forceinline__ void wide_axpy(const float* p, int row, const float* y, int split, int n, int nc,
                                          float* acc) {
  for (int j = 0; j < n; ++j) {
    const float pj = p[row * kWideS + j];
#pragma unroll
    for (int c = 0; c < kWideCols; ++c)
      if (c < nc) acc[c] = fmaf(pj, y[j * kWideO + split + kSplit * c], acc[c]);
  }
}

__device__ __forceinline__ float quad_max(unsigned quad, float x) {
  x = fmaxf(x, __shfl_xor_sync(quad, x, 1));
  return fmaxf(x, __shfl_xor_sync(quad, x, 2));
}

// K1 (kTwoPass) and K2 for D > 128. Grid (B*H, ceil(Lq/64), ceil(D/128)),
// kThreads threads, wide_fwd_smem_bytes() of dynamic shared memory.
template <typename T, bool kTwoPass>
__global__ void __launch_bounds__(kThreads)
attention_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse, int H,
               int Lq, int Lk, int D, float scale_log2) {
  extern __shared__ __align__(16) float wsm[];
  float* sq = wsm;                     // the Q chunk
  float* sk = sq + kWideTile;          // the K chunk
  float* sp = sk + kWideTile;          // the tile's rounded p
  float* sv = sp + kWideTile;          // the V tile's output columns
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sv + kWideOutTile);

  const int bh = blockIdx.x, r0 = blockIdx.y * kRows, c0 = blockIdx.z * kWideOut;
  const int nq = min(kRows, Lq - r0), w = min(kWideOut, D - c0), nc = w / kSplit;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const int row = threadIdx.x / kSplit, split = threadIdx.x % kSplit;
  const unsigned quad = 0xfu << (threadIdx.x % 32 / kSplit * kSplit);
  const T* qb = q + ((size_t)bh * Lq + r0) * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  // This thread's 16 scaled, biased scores (log2 domain) of the tile at k0.
  auto scores = [&](int k0, int nk, float* s) {
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) s[m] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();  // the previous chunk (or tile) is consumed
      wide_stage(sq, kWideS, qb, nq, D, d0, kWideChunk, kWideChunk);
      wide_stage(sk, kWideS, kb + (size_t)k0 * D, nk, D, d0, kWideChunk, kWideChunk);
      if (d0 == 0 && threadIdx.x < kFlashKeys) {
        const int j = threadIdx.x;
        svalid[j] = j < nk && (all_masked || mask_b == nullptr || mask_b[k0 + j]);
      }
      __syncthreads();
      wide_dots(sq, row, sk, split, s);
    }
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) {
      const int j = split + kSplit * m;
      s[m] = !svalid[j] ? -INFINITY : all_masked ? 0.f : s[m] * scale_log2;
    }
  };

  float m_run = -INFINITY, l_run = 0.f;
  if constexpr (kTwoPass) {  // pass 1: the row's max and normaliser
    for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
      float s[kWideKeys];
      scores(k0, min(kFlashKeys, Lk - k0), s);
      float mt = -INFINITY;
#pragma unroll
      for (int m = 0; m < kWideKeys; ++m) mt = fmaxf(mt, s[m]);
      const float m_new = fmaxf(m_run, quad_max(quad, mt));
      if (m_new == -INFINITY) continue;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kWideKeys; ++m) sum += exp2f(s[m] - m_new);
      l_run = l_run * exp2f(m_run - m_new) + quad_total(quad, sum);
      m_run = m_new;
    }
  }
  float acc[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
    const int nk = min(kFlashKeys, Lk - k0);
    float s[kWideKeys];
    scores(k0, nk, s);
    if constexpr (kTwoPass) {
      const float inv = 1.f / l_run;
#pragma unroll
      for (int m = 0; m < kWideKeys; ++m)
        sp[row * kWideS + split + kSplit * m] = wide_f(wide_t<T>(exp2f(s[m] - m_run) * inv));
    } else {
      float mt = -INFINITY;
#pragma unroll
      for (int m = 0; m < kWideKeys; ++m) mt = fmaxf(mt, s[m]);
      const float m_new = fmaxf(m_run, quad_max(quad, mt));
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kWideKeys; ++m) {
        const float p = m_new == -INFINITY ? 0.f : exp2f(s[m] - m_new);
        sum += p;
        sp[row * kWideS + split + kSplit * m] = wide_f(wide_t<T>(p));
      }
      l_run = l_run * alpha + quad_total(quad, sum);
      m_run = m_new;
#pragma unroll
      for (int c = 0; c < kWideCols; ++c) acc[c] *= alpha;
    }
    __syncthreads();  // the last chunk's readers are done before sv reuses nothing, sp is written
    wide_stage(sv, kWideO, vb + (size_t)k0 * D, nk, D, c0, w, kWideOut);
    __syncthreads();
    wide_axpy(sp, row, sv, split, nk, nc, acc);
  }
  if (row >= nq) return;
  const float inv = kTwoPass ? 1.f : 1.f / l_run;
  T* o = out + ((size_t)bh * Lq + r0 + row) * D + c0;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
    if (c < nc) o[split + kSplit * c] = wide_t<T>(acc[c] * inv);
  if (lse != nullptr && blockIdx.z == 0 && split == 0)
    lse[(size_t)bh * Lq + r0 + row] = (m_run + log2f(l_run)) * kLn2;
}

// B.4's dQ for D > 128, grid (B*H, Lq_pad/64, ceil(D/128)). Its z = 0 blocks
// also write each row's lse2 (base 2) and D = rowsum(g * out) to the scratch
// for the dK/dV kernel, as attention_bwd_dq_* do.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_wide_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, const T* __restrict__ out,
                      const float* __restrict__ lse, const T* __restrict__ g, T* __restrict__ dq,
                      float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq, int Lk,
                      int D, int Lq_pad, float scale_log2, float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* sq = wsm;                  // Q, K, g, V chunks; then the K tile's output columns
  float* sk = sq + kWideTile;
  float* sg = sk + kWideTile;
  float* sv = sg + kWideTile;
  float* sout = wsm;
  float* sds = sv + kWideTile;      // the tile's dS
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sds + kWideTile);

  const int bh = blockIdx.x, r0 = blockIdx.y * kRows, c0 = blockIdx.z * kWideOut;
  const int nq = max(0, min(kRows, Lq - r0)), w = min(kWideOut, D - c0), nc = w / kSplit;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const int row = threadIdx.x / kSplit, split = threadIdx.x % kSplit;
  const unsigned quad = 0xfu << (threadIdx.x % 32 / kSplit * kSplit);
  const bool live = row < nq;
  const size_t q_row = (size_t)bh * Lq + r0 + (live ? row : 0);

  // D_i = sum(g_i * out_i) over the whole head dim, a quarter a thread.
  float dsum = 0.f;
  if (live)
    for (int d = split; d < D; d += kSplit) dsum = fmaf(wide_f(g[q_row * D + d]), wide_f(out[q_row * D + d]), dsum);
  dsum = quad_total(quad, dsum);
  const float lse2 = live ? lse[q_row] * kLog2e : 0.f;
  if (blockIdx.z == 0 && split == 0) {
    lse2_pad[(size_t)bh * Lq_pad + r0 + row] = lse2;
    dsum_pad[(size_t)bh * Lq_pad + r0 + row] = dsum;
  }
  const T* qb = q + ((size_t)bh * Lq + r0) * D;
  const T* gb = g + ((size_t)bh * Lq + r0) * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  float acc[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
    const int nk = min(kFlashKeys, Lk - k0);
    float s[kWideKeys], dp[kWideKeys];
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) s[m] = dp[m] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();
      wide_stage(sq, kWideS, qb, nq, D, d0, kWideChunk, kWideChunk);
      wide_stage(sg, kWideS, gb, nq, D, d0, kWideChunk, kWideChunk);
      wide_stage(sk, kWideS, kb + (size_t)k0 * D, nk, D, d0, kWideChunk, kWideChunk);
      wide_stage(sv, kWideS, vb + (size_t)k0 * D, nk, D, d0, kWideChunk, kWideChunk);
      if (d0 == 0 && threadIdx.x < kFlashKeys) {
        const int j = threadIdx.x;
        svalid[j] = j < nk && (all_masked || mask_b == nullptr || mask_b[k0 + j]);
      }
      __syncthreads();
      wide_dots(sq, row, sk, split, s);
      wide_dots(sg, row, sv, split, dp);
    }
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) {
      const int j = split + kSplit * m;
      const float p = svalid[j] ? exp2f((all_masked ? 0.f : s[m] * scale_log2) - lse2) : 0.f;
      sds[row * kWideS + j] = live ? p * (dp[m] - dsum) : 0.f;
    }
    __syncthreads();  // the chunks are consumed; sout reuses them
    wide_stage(sout, kWideO, kb + (size_t)k0 * D, nk, D, c0, w, kWideOut);
    __syncthreads();
    wide_axpy(sds, row, sout, split, nk, nc, acc);
  }
  if (!live) return;
  T* o = dq + q_row * D + c0;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c)
    if (c < nc) o[split + kSplit * c] = wide_t<T>(acc[c] * scale);
}

// B.4's dK/dV for D > 128, grid (B*H, ceil(Lk/64), ceil(D/128)): a block
// owns 64 keys (a key's four threads split the query rows of a tile) and
// 128 columns of dK and dV, and walks the query rows in 64-row tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_wide_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const uint8_t* __restrict__ mask, const T* __restrict__ g, T* __restrict__ dk,
                        T* __restrict__ dv, const float* __restrict__ lse2_pad,
                        const float* __restrict__ dsum_pad, int H, int Lq, int Lk, int D, int Lq_pad,
                        float scale_log2, float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* sk = wsm;                  // K, V, Q, g chunks; then Q's and g's output columns
  float* sv = sk + kWideTile;
  float* sq = sv + kWideTile;
  float* sg = sq + kWideTile;
  float* soq = wsm;
  float* sog = wsm + kWideOutTile;
  float* sp = sg + kWideTile;       // P^T and dS^T of the tile (key rows)
  float* sds = sp + kWideTile;
  float* slse2 = sds + kWideTile;
  float* sdsum = slse2 + kRows;

  const int bh = blockIdx.x, k0 = blockIdx.y * kFlashKeys, c0 = blockIdx.z * kWideOut;
  const int nk = min(kFlashKeys, Lk - k0), w = min(kWideOut, D - c0), nc = w / kSplit;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const int row = threadIdx.x / kSplit, split = threadIdx.x % kSplit;
  const bool live = row < nk;
  const bool valid = live && (all_masked || mask_b == nullptr || mask_b[k0 + row]);
  const T* kb = k + ((size_t)bh * Lk + k0) * D;
  const T* vb = v + ((size_t)bh * Lk + k0) * D;
  float dk_acc[kWideCols], dv_acc[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) dk_acc[c] = dv_acc[c] = 0.f;
  for (int r0 = 0; r0 < Lq; r0 += kRows) {
    const int nq = min(kRows, Lq - r0);
    const T* qb = q + ((size_t)bh * Lq + r0) * D;
    const T* gb = g + ((size_t)bh * Lq + r0) * D;
    float s[kWideKeys], dp[kWideKeys];
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) s[m] = dp[m] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideChunk) {
      __syncthreads();
      wide_stage(sk, kWideS, kb, nk, D, d0, kWideChunk, kWideChunk);
      wide_stage(sv, kWideS, vb, nk, D, d0, kWideChunk, kWideChunk);
      wide_stage(sq, kWideS, qb, nq, D, d0, kWideChunk, kWideChunk);
      wide_stage(sg, kWideS, gb, nq, D, d0, kWideChunk, kWideChunk);
      if (d0 == 0 && threadIdx.x < kRows) {
        slse2[threadIdx.x] = lse2_pad[(size_t)bh * Lq_pad + r0 + threadIdx.x];
        sdsum[threadIdx.x] = dsum_pad[(size_t)bh * Lq_pad + r0 + threadIdx.x];
      }
      __syncthreads();
      wide_dots(sk, row, sq, split, s);   // s[m] = k_row . q_(split+4m)
      wide_dots(sv, row, sg, split, dp);  // dp[m] = v_row . g_(split+4m)
    }
#pragma unroll
    for (int m = 0; m < kWideKeys; ++m) {
      const int i = split + kSplit * m;
      const float p = valid && i < nq ? exp2f((all_masked ? 0.f : s[m] * scale_log2) - slse2[i]) : 0.f;
      sp[row * kWideS + i] = p;
      sds[row * kWideS + i] = p * (dp[m] - sdsum[i]);
    }
    __syncthreads();  // the chunks are consumed; soq and sog reuse them
    wide_stage(soq, kWideO, qb, nq, D, c0, w, kWideOut);
    wide_stage(sog, kWideO, gb, nq, D, c0, w, kWideOut);
    __syncthreads();
    wide_axpy(sp, row, sog, split, nq, nc, dv_acc);
    wide_axpy(sds, row, soq, split, nq, nc, dk_acc);
  }
  if (!live) return;
  const size_t o = ((size_t)bh * Lk + k0 + row) * D + c0;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    if (c < nc) {
      dk[o + split + kSplit * c] = wide_t<T>(dk_acc[c] * scale);
      dv[o + split + kSplit * c] = wide_t<T>(dv_acc[c]);
    }
  }
}

constexpr size_t wide_fwd_smem_bytes() {
  return (size_t)(3 * kWideTile + kWideOutTile) * sizeof(float) + kFlashKeys;
}
constexpr size_t wide_dq_smem_bytes() { return (size_t)5 * kWideTile * sizeof(float) + kFlashKeys; }
constexpr size_t wide_dkdv_smem_bytes() { return (size_t)(6 * kWideTile + 2 * kRows) * sizeof(float); }
static_assert(2 * kWideOutTile <= 4 * kWideTile, "the output chunks fit where the four staged chunks were");

template <typename T>
cudaError_t launch_wide(bool flash, const T* q, const T* k, const T* v, const uint8_t* mask, T* out,
                        float* lse, int B, int H, int Lq, int Lk, int D, float scale_log2,
                        cudaStream_t stream) {
  if (D % kWideChunk != 0) return cudaErrorInvalidValue;
  const dim3 grid(B * H, (Lq + kRows - 1) / kRows, (D + kWideOut - 1) / kWideOut);
  constexpr size_t smem = wide_fwd_smem_bytes();
  auto kernel = flash ? attention_wide<T, false> : attention_wide<T, true>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse, H, Lq, Lk, D, scale_log2);
  return cudaGetLastError();
}

// Query rows of the backward's scratch for one (batch*head): Lq rounded up
// to the dQ kernel's row block, 128 for the bf16 Hopper pair (head dims 64,
// 128, 192 and 256) and 64 for every other body. The one rule for it: the
// launchers pad by it, and the wrapper allocates by
// attention_backward_scratch_rows.
int scratch_rows(int dtype, int Lq, int D) {
  const int tile = dtype == 1 && (D == 64 || D == 128 || D == 192 || D == 256) ? kWgRows : kRows;
  return (Lq + tile - 1) / tile * tile;
}

template <typename T>
cudaError_t launch_backward_wide(const T* q, const T* k, const T* v, const uint8_t* mask, const T* out,
                                 const float* lse, const T* g, T* dq, T* dk, T* dv, float* scratch, int B,
                                 int H, int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  if (D % kWideChunk != 0) return cudaErrorInvalidValue;
  const int Lq_pad = scratch_rows(std::is_same_v<T, float> ? 0 : 1, Lq, D);
  float* lse2_pad = scratch;
  float* dsum_pad = scratch + (size_t)B * H * Lq_pad;
  const float scale_log2 = kLog2e * scale;
  const int zs = (D + kWideOut - 1) / kWideOut;
  cudaError_t err;
  if ((err = allow_smem(attention_wide_bwd_dq<T>, wide_dq_smem_bytes())) != cudaSuccess) return err;
  attention_wide_bwd_dq<T><<<dim3(B * H, Lq_pad / kRows, zs), kThreads, wide_dq_smem_bytes(), stream>>>(
      q, k, v, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, D, Lq_pad, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attention_wide_bwd_dkdv<T>, wide_dkdv_smem_bytes())) != cudaSuccess) return err;
  attention_wide_bwd_dkdv<T><<<dim3(B * H, (Lk + kFlashKeys - 1) / kFlashKeys, zs), kThreads,
                               wide_dkdv_smem_bytes(), stream>>>(
      q, k, v, mask, g, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, D, Lq_pad, scale_log2, scale);
  return cudaGetLastError();
}

// ===================================================================== launch
// Dynamic shared memory of the float32 bodies: K1 (K and V, the query tile
// below D = 128 and the mask bytes), the D = 128 K2 and dQ bodies (a 64-key
// tile of K and V and its mask bytes) and dK/dV (a 64-row tile of Q and g,
// and their lse2 and D).
size_t whole_kv_f32_smem_bytes(int Lk, int D) {
  return (size_t)2 * Lk * D * sizeof(float) + (D > 64 ? 0 : (size_t)kRows * D * sizeof(float)) + Lk;
}
constexpr size_t flash_f32_slice_smem_bytes(int D) { return (size_t)2 * kFlashKeys * D * sizeof(float) + kFlashKeys; }
constexpr size_t bwd_dkdv_f32_smem_bytes(int D) { return ((size_t)2 * kRows * D + 2 * kRows) * sizeof(float); }

// The 3-D TMA map of a (B*H, L, D) bf16 tensor, read in boxes of `rows`
// rows x 64 columns (a 128-byte panel, swizzled by 128 bytes): zero past row
// L, and never into the next head.
bool head_map(CUtensorMap* map, const void* x, int BH, int L, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Make the context of the device that holds x current on this thread. The
// driver's tensor-map encoder needs one, and a thread whose first CUDA call
// is a launch here has none: autograd runs a backward on a thread of its own.
cudaError_t bind_device(const void* x) {
  cudaPointerAttributes a;
  const cudaError_t err = cudaPointerGetAttributes(&a, x);
  return err != cudaSuccess ? err : cudaSetDevice(a.device);
}

// K2 at head dim 64, 128, 192 or 256: ceil(Lq / 128) x B*H blocks (a
// head's query blocks side by side, so that its K and V stay in L2).
template <int D>
cudaError_t launch_flash_wgmma(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask, bf16* out,
                               float* lse, int B, int H, int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  constexpr int kKeys = WgTiles<D>::kFlashKeys;
  constexpr size_t smem = FlashLayout<D>::kSmem;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (B * H > 65535 || !head_map(&tq, q, B * H, Lq, D, kWgRows) || !head_map(&tk, k, B * H, Lk, D, kKeys) ||
      !head_map(&tv, v, B * H, Lk, D, kKeys))
    return cudaErrorInvalidValue;
  constexpr bool kInline = D > WGMMA_INLINE_ABOVE;
  const auto kernel = [] {
    if constexpr (kInline) return attention_flash_wgmma_inline<D>;
    else return attention_flash_wgmma<D>;
  }();
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const dim3 grid((Lq + kWgRows - 1) / kWgRows, B * H);
  kernel<<<grid, kInline ? kWgConsumerThreads : kWgBlockThreads, smem, stream>>>(tq, tk, tv, mask, out, lse, H, Lq,
                                                                                Lk, scale_log2);
  return cudaGetLastError();
}

// B.4's pair at head dim 64, 128, 192 or 256: the dQ kernel over 128-row
// query blocks (it writes the scratch, rows padded to 128), then the dK/dV
// kernel over 128-key blocks, D / 64 of them a key block (grid z).
template <int D>
cudaError_t launch_backward_wgmma(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask,
                                  const bf16* out, const float* lse, const bf16* g, bf16* dq, bf16* dk, bf16* dv,
                                  float* lse2_pad, float* dsum_pad, int B, int H, int Lq, int Lk, int Lq_pad,
                                  float scale_log2, float scale, cudaStream_t stream) {
  using T = WgTiles<D>;
  const int BH = B * H;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tg, tk, tv, tk2, tv2, tq2, tg2;
  if (BH > 65535 || Lq_pad % kWgRows != 0 || !head_map(&tq, q, BH, Lq, D, kWgRows) ||
      !head_map(&tg, g, BH, Lq, D, kWgRows) || !head_map(&tk, k, BH, Lk, D, T::kDqKeys) ||
      !head_map(&tv, v, BH, Lk, D, T::kDqKeys) || !head_map(&tk2, k, BH, Lk, D, kWgRows) ||
      !head_map(&tv2, v, BH, Lk, D, kWgRows) || !head_map(&tq2, q, BH, Lq, D, T::kDkdvRows) ||
      !head_map(&tg2, g, BH, Lq, D, T::kDkdvRows))
    return cudaErrorInvalidValue;
  constexpr bool kInline = D > WGMMA_INLINE_ABOVE;
  const auto dq_kernel = [] {
    if constexpr (kInline) return attention_bwd_dq_wgmma_inline<D>;
    else return attention_bwd_dq_wgmma<D>;
  }();
  if ((err = allow_smem(dq_kernel, DqLayout<D>::kSmem)) != cudaSuccess) return err;
  dq_kernel<<<dim3(Lq_pad / kWgRows, BH), kInline ? kWgConsumerThreads : kWgBlockThreads, DqLayout<D>::kSmem,
              stream>>>(tq, tg, tk, tv, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2,
                        scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attention_bwd_dkdv_wgmma<D>, DkdvLayout<D>::kSmem)) != cudaSuccess) return err;
  attention_bwd_dkdv_wgmma<D><<<dim3((Lk + kWgRows - 1) / kWgRows, BH, D / kPanel), kWgBlockThreads,
                                DkdvLayout<D>::kSmem, stream>>>(tk2, tv2, tq2, tg2, mask, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad,
                                          scale_log2, scale);
  return cudaGetLastError();
}

// K1's grid: `blocks` query-row blocks per (batch*head) of `threads`
// threads each, as kernels/attention.py::whole_kv_plan gives it. K2's grid
// has no choice in it and is set here. lse may be null; K1's bf16 body
// writes none and refuses a pointer.
template <int D>
cudaError_t launch_f32(bool flash, const float* q, const float* k, const float* v,
                       const uint8_t* mask, float* out, float* lse, int B, int H, int Lq, int Lk,
                       int blocks, int threads, float scale_log2, cudaStream_t stream) {
  if (flash) {
    const dim3 grid(B * H, (Lq + kRows - 1) / kRows);
    if constexpr (D > 64) {
      constexpr size_t smem = flash_f32_slice_smem_bytes(D);
      const cudaError_t err = allow_smem(attention_flash_slice<D>, smem);
      if (err != cudaSuccess) return err;
      attention_flash_slice<D><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse, H, Lq, Lk,
                                                                 scale_log2);
    } else {
      attention_flash_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, mask, out, lse, H, Lq, Lk,
                                                               scale_log2);
    }
  } else {
    if (threads != kThreads || blocks < 1 || blocks * kRows < Lq) return cudaErrorInvalidValue;
    const dim3 grid(B * H, blocks);
    const size_t smem = whole_kv_f32_smem_bytes(Lk, D);
    auto kernel = [] {
      if constexpr (D > 64) return attention_whole_kv_slice<D>;
      else return attention_whole_kv_kernel<D>;
    }();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse, H, Lq, Lk, scale_log2);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(bool flash, const bf16* q, const bf16* k, const bf16* v,
                        const uint8_t* mask, bf16* out, float* lse, int B, int H, int Lq, int Lk,
                        int blocks, int threads, float scale_log2, cudaStream_t stream) {
  if (flash) {
    if constexpr (D >= 64) {  // the Hopper body
      return launch_flash_wgmma<D>(q, k, v, mask, out, lse, B, H, Lq, Lk, scale_log2, stream);
    } else {
      const int warp_tiles = (Lq + kWarpRows - 1) / kWarpRows;
      const dim3 grid(B * H, (warp_tiles + kFlashWarps - 1) / kFlashWarps);
      constexpr size_t smem = Ring<D, 1>::kBytes;
      const cudaError_t err = allow_smem(attention_flash_mma<D>, smem);
      if (err != cudaSuccess) return err;
      attention_flash_mma<D><<<grid, kFlashWarps * 32, smem, stream>>>(q, k, v, mask, out, lse, H, Lq,
                                                                       Lk, scale_log2);
    }
  } else {
    const int warps = threads / 32;
    if (lse != nullptr || threads % 32 != 0 || warps < 1 || warps > whole_kv_max_warps(D) ||
        blocks < 1 || blocks * warps * kWarpRows < Lq)
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
             const void* mask, void* out, void* lse, int B, int H, int Lq, int Lk, int D,
             float scale, int blocks, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = kLog2e * scale;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (flash && dtype == 1 && (D == 192 || D == 256)) {  // bf16 K2 above 128: the Hopper bodies
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v);
    bf16* bo = static_cast<bf16*>(out);
    err = D == 192 ? launch_flash_wgmma<192>(bq, bk, bv, m, bo, l, B, H, Lq, Lk, scale_log2, s)
                   : launch_flash_wgmma<256>(bq, bk, bv, m, bo, l, B, H, Lq, Lk, scale_log2, s);
    return (int)err;
  }
  if (D > 128) {  // the chunked bodies (C.7); K1's grid arguments do not apply
    if (dtype == 0)
      err = launch_wide(flash, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), m, static_cast<float*>(out), l, B, H, Lq, Lk, D,
                        scale_log2, s);
    if (dtype == 1)
      err = launch_wide(flash, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), m, static_cast<bf16*>(out), l, B, H, Lq, Lk, D,
                        scale_log2, s);
    return (int)err;
  }
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* fo = static_cast<float*>(out);
    if (D == 16)
      err = launch_f32<16>(flash, fq, fk, fv, m, fo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 32)
      err = launch_f32<32>(flash, fq, fk, fv, m, fo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 64)
      err = launch_f32<64>(flash, fq, fk, fv, m, fo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 128)
      err = launch_f32<128>(flash, fq, fk, fv, m, fo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
  } else if (dtype == 1) {
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v);
    bf16* bo = static_cast<bf16*>(out);
    if (D == 16)
      err = launch_bf16<16>(flash, bq, bk, bv, m, bo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 32)
      err = launch_bf16<32>(flash, bq, bk, bv, m, bo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 64)
      err = launch_bf16<64>(flash, bq, bk, bv, m, bo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
    if (D == 128)
      err = launch_bf16<128>(flash, bq, bk, bv, m, bo, l, B, H, Lq, Lk, blocks, threads, scale_log2, s);
  }
  return (int)err;
}

// The backward pair: the dQ kernel (which writes the scratch), then the
// dK/dV kernel, both on `stream`. scratch holds lse2 then D, each
// (B*H, Lq_pad) floats.
template <typename T, int D>
cudaError_t launch_backward(const T* q, const T* k, const T* v, const uint8_t* mask, const T* out,
                            const float* lse, const T* g, T* dq, T* dk, T* dv, float* scratch,
                            int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  const int Lq_pad = scratch_rows(std::is_same_v<T, float> ? 0 : 1, Lq, D);
  float* lse2_pad = scratch;
  float* dsum_pad = scratch + (size_t)B * H * Lq_pad;
  // scale_log2 as the forward computes it, so that S is the forward's to the bit
  const float scale_log2 = kLog2e * scale;
  if constexpr (!std::is_same_v<T, float> && D >= 64) {  // the Hopper pair
    return launch_backward_wgmma<D>(q, k, v, mask, out, lse, g, dq, dk, dv, lse2_pad, dsum_pad, B, H, Lq, Lk,
                                    Lq_pad, scale_log2, scale, stream);
  } else {
    const dim3 grid_q(B * H, Lq_pad / kRows), grid_k(B * H, (Lk + kTileKeys - 1) / kTileKeys);
    cudaError_t err;
    if constexpr (std::is_same_v<T, float> && D > 64) {
      constexpr size_t smem = flash_f32_slice_smem_bytes(D);
      if ((err = allow_smem(attention_bwd_dq_slice<D>, smem)) != cudaSuccess) return err;
      attention_bwd_dq_slice<D><<<grid_q, kThreads, smem, stream>>>(
          q, k, v, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
    } else if constexpr (std::is_same_v<T, float>) {
      attention_bwd_dq_kernel<D><<<grid_q, kThreads, 0, stream>>>(
          q, k, v, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
    } else {
      constexpr size_t smem = Ring<D, 1>::kBytes;
      if ((err = allow_smem(attention_bwd_dq_mma<D>, smem)) != cudaSuccess) return err;
      attention_bwd_dq_mma<D><<<grid_q, kFlashWarps * 32, smem, stream>>>(
          q, k, v, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if constexpr (std::is_same_v<T, float>) {
      constexpr size_t smem = bwd_dkdv_f32_smem_bytes(D);
      if ((err = allow_smem(attention_bwd_dkdv_kernel<D>, smem)) != cudaSuccess) return err;
      attention_bwd_dkdv_kernel<D><<<grid_k, kThreads, smem, stream>>>(
          q, k, v, mask, g, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
    } else {
      constexpr size_t smem = Ring<D, 2>::kBytes;
      if ((err = allow_smem(attention_bwd_dkdv_mma<D>, smem)) != cudaSuccess) return err;
      attention_bwd_dkdv_mma<D><<<grid_k, kFlashWarps * 32, smem, stream>>>(
          q, k, v, mask, g, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
    }
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_backward(int D, const void* q, const void* k, const void* v, const void* mask,
                              const void* out, const void* lse, const void* g, void* dq, void* dk,
                              void* dv, void* scratch, int B, int H, int Lq, int Lk, float scale,
                              cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(out),
          *tg = static_cast<const T*>(g);
  T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk), *tdv = static_cast<T*>(dv);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (D == 16) return launch_backward<T, 16>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, scale, stream);
  if (D == 32) return launch_backward<T, 32>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, scale, stream);
  if (D == 64) return launch_backward<T, 64>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, scale, stream);
  if (D == 128) return launch_backward<T, 128>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, scale, stream);
  if constexpr (!std::is_same_v<T, float>) {  // bf16 above 128: the Hopper pair at 192 and 256
    if (D == 192)
      return launch_backward<T, 192>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, scale, stream);
    if (D == 256)
      return launch_backward<T, 256>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, scale, stream);
  }
  if (D > 128) return launch_backward_wide<T>(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, D, scale, stream);
  return cudaErrorInvalidValue;
}

// Every attention kernel instantiation, for attention_kernel_attributes.
struct Entry {
  const char* name;
  const void* fn;
};
const Entry kKernels[] = {
    {"attention_whole_kv_mma<bf16,16>", (const void*)attention_whole_kv_mma<16>},
    {"attention_whole_kv_mma<bf16,32>", (const void*)attention_whole_kv_mma<32>},
    {"attention_whole_kv_mma<bf16,64>", (const void*)attention_whole_kv_mma<64>},
    {"attention_whole_kv_mma<bf16,128>", (const void*)attention_whole_kv_mma<128>},
    {"attention_flash_mma<bf16,16>", (const void*)attention_flash_mma<16>},
    {"attention_flash_mma<bf16,32>", (const void*)attention_flash_mma<32>},
    {"attention_flash_wgmma<bf16,64>", (const void*)attention_flash_wgmma<64>},
    {"attention_flash_wgmma<bf16,128>", (const void*)attention_flash_wgmma<128>},
    {"attention_flash_wgmma_inline<bf16,192>", (const void*)attention_flash_wgmma_inline<192>},
    {"attention_flash_wgmma_inline<bf16,256>", (const void*)attention_flash_wgmma_inline<256>},
    {"attention_whole_kv_kernel<float,16>", (const void*)attention_whole_kv_kernel<16>},
    {"attention_whole_kv_kernel<float,32>", (const void*)attention_whole_kv_kernel<32>},
    {"attention_whole_kv_kernel<float,64>", (const void*)attention_whole_kv_kernel<64>},
    {"attention_whole_kv_slice<float,128>", (const void*)attention_whole_kv_slice<128>},
    {"attention_flash_kernel<float,16>", (const void*)attention_flash_kernel<16>},
    {"attention_flash_kernel<float,32>", (const void*)attention_flash_kernel<32>},
    {"attention_flash_kernel<float,64>", (const void*)attention_flash_kernel<64>},
    {"attention_flash_slice<float,128>", (const void*)attention_flash_slice<128>},
    {"attention_bwd_dq_mma<bf16,16>", (const void*)attention_bwd_dq_mma<16>},
    {"attention_bwd_dq_mma<bf16,32>", (const void*)attention_bwd_dq_mma<32>},
    {"attention_bwd_dq_wgmma<bf16,64>", (const void*)attention_bwd_dq_wgmma<64>},
    {"attention_bwd_dq_wgmma<bf16,128>", (const void*)attention_bwd_dq_wgmma<128>},
    {"attention_bwd_dq_wgmma_inline<bf16,192>", (const void*)attention_bwd_dq_wgmma_inline<192>},
    {"attention_bwd_dq_wgmma_inline<bf16,256>", (const void*)attention_bwd_dq_wgmma_inline<256>},
    {"attention_bwd_dkdv_mma<bf16,16>", (const void*)attention_bwd_dkdv_mma<16>},
    {"attention_bwd_dkdv_mma<bf16,32>", (const void*)attention_bwd_dkdv_mma<32>},
    {"attention_bwd_dkdv_wgmma<bf16,64>", (const void*)attention_bwd_dkdv_wgmma<64>},
    {"attention_bwd_dkdv_wgmma<bf16,128>", (const void*)attention_bwd_dkdv_wgmma<128>},
    {"attention_bwd_dkdv_wgmma<bf16,192>", (const void*)attention_bwd_dkdv_wgmma<192>},
    {"attention_bwd_dkdv_wgmma<bf16,256>", (const void*)attention_bwd_dkdv_wgmma<256>},
    {"attention_bwd_dq_kernel<float,16>", (const void*)attention_bwd_dq_kernel<16>},
    {"attention_bwd_dq_kernel<float,32>", (const void*)attention_bwd_dq_kernel<32>},
    {"attention_bwd_dq_kernel<float,64>", (const void*)attention_bwd_dq_kernel<64>},
    {"attention_bwd_dq_slice<float,128>", (const void*)attention_bwd_dq_slice<128>},
    {"attention_bwd_dkdv_kernel<float,16>", (const void*)attention_bwd_dkdv_kernel<16>},
    {"attention_bwd_dkdv_kernel<float,32>", (const void*)attention_bwd_dkdv_kernel<32>},
    {"attention_bwd_dkdv_kernel<float,64>", (const void*)attention_bwd_dkdv_kernel<64>},
    {"attention_bwd_dkdv_kernel<float,128>", (const void*)attention_bwd_dkdv_kernel<128>},
    {"attention_wide<bf16,K1>", (const void*)attention_wide<bf16, true>},
    {"attention_wide<bf16,K2>", (const void*)attention_wide<bf16, false>},
    {"attention_wide<float,K1>", (const void*)attention_wide<float, true>},
    {"attention_wide<float,K2>", (const void*)attention_wide<float, false>},
    {"attention_wide_bwd_dq<bf16>", (const void*)attention_wide_bwd_dq<bf16>},
    {"attention_wide_bwd_dkdv<bf16>", (const void*)attention_wide_bwd_dkdv<bf16>},
    {"attention_wide_bwd_dq<float>", (const void*)attention_wide_bwd_dq<float>},
    {"attention_wide_bwd_dkdv<float>", (const void*)attention_wide_bwd_dkdv<float>},
};

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mask: (B, Lk) bytes (torch.bool), or null for no mask. lse: (B, H, Lq)
// float32, or null to write none. D: 16, 32, 64, 128, or a multiple of 64
// above 128 (bf16 K2 and the pair at 192 and 256 on the Hopper bodies, the
// rest on the chunked ones, which take any lse); scale: the softmax
// scale, 1/sqrt of the head dim before any zero padding (the wrapper pads
// other head dims). stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success). K1 takes its grid (blocks per
// batch*head, threads a block) from kernels/attention.py::whole_kv_plan, and
// refuses one that leaves query rows without a warp, and an lse pointer in
// bf16 (cudaErrorInvalidValue).
extern "C" int attention_whole_kv(int dtype, const void* q, const void* k, const void* v,
                                  const void* mask, void* out, void* lse, int B, int H, int Lq,
                                  int Lk, int D, float scale, int blocks, int threads,
                                  void* stream) {
  return dispatch(false, dtype, q, k, v, mask, out, lse, B, H, Lq, Lk, D, scale, blocks, threads,
                  stream);
}

extern "C" int attention_flash(int dtype, const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B, int H, int Lq,
                               int Lk, int D, float scale, void* stream) {
  return dispatch(true, dtype, q, k, v, mask, out, lse, B, H, Lq, Lk, D, scale, 0, 0, stream);
}

// B.4's backward: dq, dk, dv (each like its input) from q, k, v, the mask,
// the forward's out and lse (non-null), and the output gradient g. scratch:
// 2 x B x H x Lq_pad floats, Lq_pad = attention_backward_scratch_rows(dtype,
// Lq, D) (the wrapper allocates it; the dQ kernel fills it for the dK/dV
// kernel, which reads it in whole tiles).
extern "C" int attention_backward(int dtype, const void* q, const void* k, const void* v,
                                  const void* mask, const void* out, const void* lse,
                                  const void* g, void* dq, void* dk, void* dv, void* scratch,
                                  int B, int H, int Lq, int Lk, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse == nullptr || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_backward<float>(D, q, k, v, mask, out, lse, g, dq, dk, dv, scratch, B, H,
                                         Lq, Lk, scale, s);
  if (dtype == 1)
    return (int)dispatch_backward<bf16>(D, q, k, v, mask, out, lse, g, dq, dk, dv, scratch, B, H,
                                        Lq, Lk, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The rows Lq_pad of attention_backward's scratch for one (batch*head), at
// this dtype, Lq and head dim; -1 for a dtype or Lq it does not take.
extern "C" int attention_backward_scratch_rows(int dtype, int Lq, int D) {
  return (dtype == 0 || dtype == 1) && Lq >= 0 ? scratch_rows(dtype, Lq, D) : -1;
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
