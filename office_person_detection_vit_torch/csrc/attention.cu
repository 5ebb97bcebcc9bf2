// Scaled-dot-product attention with a key padding mask, hand-written for
// Hopper (sm_90a). Two forward kernels with one contract:
//
//   out[b,h,i,:] = sum_j round_T(p[i,j]) * v[b,h,j,:],
//   p[i,:] = softmax over the valid keys j of (q[b,h,i,:] . k[b,h,j,:]) / sqrt(D)
//
// with q/k/v laid out (B, H, L, D) contiguous, T = float or bfloat16, scores,
// softmax and accumulation in float32, the output in T. Given a pointer, K2
// (both types) and K1 (float32, and bf16 above head dim 128) also write
// lse[b,h,i], the float32
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
// bf16 design (tensor cores). K2 and the backward pair at every head dim
// run Hopper bodies (TMA, wgmma): at 64, 128, 192 and 256 those of the
// wgmma section below (two warpgroups of 64 rows; ViT-base/16's D 64,
// ViT-H/16's 80 padded to 128, the VITW DETR's 256), at 16 and 32 (DETR's
// own heads) the narrow bodies of the section after it (the 64- and
// 32-byte swizzles; the softmax overlapped with the products), K1 above
// 128 and K2 above 256 the panel bodies (wgmma, TMA) of the section after
// the C.7 one. K1 up to 128 runs the mma.sync body described here:
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
//    K2 and the pair take the wgmma bodies at 192 and 256, every other
//    forward there the panel bodies (both types; wgmma in bf16), the
//    float32 pair the register-tiled pair and the bf16 pair above 256 the
//    wgmma pair on column panels (the pair's sections below).
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
//  * At D = 128 K1 takes at most 8 warps a block (255 registers a thread
//    instead of 128).
//  * K2 (every bf16 body) walks K/V in tiles with the online max and
//    normalizer of _flash_attn_kernel; the loop inside the block replaces
//    the TPU's sequential KV grid axis.
//
// float32. One TF32 product would break the 1e-5 tolerance and the
// whole-model float32 bar, so the float32 bodies keep float32's accuracy
// in one of three designs:
//  * K2 and the backward pair up to 128 on the tensor cores as three TF32
//    products a float32 product (3xTF32: attention_flash_tf32, and
//    attention_bwd_{dq,dkdv}_tf32; their sections say how).
//  * four threads per query row, 64-row blocks, FP32 FMAs: K1 at D 16 and
//    32 (DETR's; no path calls it since float32 K2 takes those head dims
//    too). A row's four threads split its keys and each keeps the whole
//    row of q and of the output. Each of its FMAs reads its operand from
//    shared memory, a float4 for four FMAs, so it runs at a fraction of
//    the FMA rate.
//  * register tiles (attention_panels_fma, attention_bwd_*_fma): 16 x 16
//    threads, each a 4 x 4 tile of scores, float4 operands reused across
//    four rows and four keys from registers, items by cp.async into two
//    slots: K1 at D 64 and 128 (three and two blocks an SM), every forward
//    above 128 and the pair above 128. Their sections say how.
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
// At D 16 and 32; K1 at 64 and 128 runs attention_panels_fma.
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

// ===================================================== bf16 (tensor cores)
constexpr int kWarpRows = 16;          // query rows per warp (one m16 tile)
constexpr int kTileKeys = 64;          // keys per score tile
// K1: at most 256 query rows a block (launch bounds); 128 at D = 128, where
// a thread needs more than the 128 registers 16 warps leave it.
constexpr int whole_kv_max_warps(int D) { return D <= 64 ? 16 : 8; }
constexpr int kFlashWarps = 4;         // float32 K2 and pair: 64 query rows a block

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

// ================================= K2 in float32 up to head dim 128 (3xTF32)
// float32 K2 at head dims 16, 32, 64 and 128 (and those padded to them) on
// the tensor cores, at float32's accuracy: three TF32 products a float32
// product, as CUTLASS's OpMultiplyAddFastF32 (which SDPA's float32 path
// runs) does.
//  * Each float32 operand x is split into hi = tf32(x) (10 bits of mantissa,
//    rounded to nearest) and lo = x - hi (split_tf32), and a product a b is
//    lo_a hi_b + hi_a lo_b + hi_a hi_b on
//    mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, summed in float32
//    accumulators (the small terms first; P.V a group of 32 keys in an
//    accumulator of its own, added to the output by FADD). What it drops, lo_a lo_b and lo's own
//    truncation, is about 2^-21 of |a b|, where one TF32 product alone
//    rounds each operand to 2^-11.
//  * The skeleton of the bf16 K2 that ran at D 16 and 32 until the narrow
//    Hopper bodies: a warp owns 16 query rows, 4
//    warps a block (64 rows); K and V come in kKeys-key tiles (64; 32 at D
//    128, for registers and shared memory) by 16-byte cp.async into two
//    stages, the next tile loading under the current one's products, with
//    the tile's key bias beside them; online softmax in base 2 in the
//    m16n8 accumulator layout (a row's max and sum over the quad that holds
//    it). Rows past Lk are zero-filled, rows past Lq are zero in Q and not
//    stored. Grid (ceil(Lq / 64), B*H): a head's row blocks side by side,
//    so that its K and V stay in L2.
//  * Fragments come from shared memory by 32- and 64-bit loads (ldmatrix
//    has no 32-bit transpose). The depth of each product is permuted inside
//    each k8 step so that a thread's two depth values are neighbours: in
//    Q.K^T columns 2t and 2t + 1 of Q and of K (one 64-bit load of K), in
//    P.V keys 2t and 2t + 1, which is where the score accumulator already
//    holds them, so p becomes P.V's A operand with no shuffle. K rows are
//    padded to D + 8 floats and V rows to D + 4, so that each load of a warp
//    meets every bank once.
//  * Each operand is split once, where it is loaded, and its hi and lo
//    serve all three products: Q from registers once a tile, p once, K and
//    V as a warp reads them. A split kept in shared memory (once a staged
//    tile for all four warps) would double the warps' shared reads (hi and
//    lo); in registers it costs three ALU instructions an operand beside
//    the tensor cores.
//  * Bound: operations, on the tensor cores: Q.K^T and P.V over the valid
//    keys, three TF32 products each, at 495 / 3 = 165 TFLOP/s of float32
//    work; at ViT-base/16's float32 (1, 12, 3681, 3681, 64) 41.6 GFLOP,
//    0.252 ms, and 163 M exponentials.
template <int D> struct Tf32Flash {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  static constexpr int kKeys = D == 128 ? 32 : 64;                   // keys a tile
  static constexpr int kLdK = D + 8, kLdV = D + 4;                   // row strides (floats)
  static constexpr int kStage = kKeys * (kLdK + kLdV) + kKeys;       // floats: K, V, the key bias
  static constexpr size_t kSmem = 2 * (size_t)kStage * sizeof(float);
  static constexpr int kMinBlocks = D >= 64 ? 2 : D == 16 ? 4 : 3;  // blocks an SM (launch bounds)
};
static_assert(3 * (Tf32Flash<32>::kSmem + 1024) <= 233472 && 2 * (Tf32Flash<128>::kSmem + 1024) <= 233472,
              "the blocks an SM of the launch bounds fit its shared memory");

// x = hi + lo: hi = x rounded to TF32's 10 bits of mantissa (to nearest,
// ties away: an add and a mask of the bits; finite x), lo = x - hi exactly
// in float32. lo goes to the product as it is: the tensor cores read a .tf32
// operand's top 19 bits, so they truncate it to 10 bits of its own (2^-10 of
// |lo| <= 2^-21 of |x|). cvt.rna.tf32.f32 would round lo too, but it
// compiles to a dozen instructions that check for NaN and infinity, where
// this split is three; it ran the body slower (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// The same, done where it is written: Q's split stays inside the tile loop.
// Hoisted out of it (Q does not change), its hi and lo would hold D
// registers a thread for the whole block where Q's floats hold D / 2.
__device__ __forceinline__ void split_tf32_here(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile("{\n .reg .b32 t;\n add.u32 t, %1, 4096;\n and.b32 %0, t, 0xffffe000;\n}\n"
               : "=r"(hi)
               : "r"(__float_as_uint(x)));
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in 3xTF32: the split operands' lo hi, hi lo, then hi hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Rows [0, n) of a row-major (.., D) float array into `rows` shared rows of
// ld floats by 16-byte cp.async; rows n.. are zero-filled.
template <int D>
__device__ __forceinline__ void stage_f32_rows(float* dst, int ld, const float* src, int n, int rows) {
  constexpr int kC = D / 4;
#pragma unroll 1
  for (int e = threadIdx.x; e < rows * kC; e += blockDim.x) {
    const int r = e / kC, c = e % kC * 4;
    const bool ok = r < n;
    cp_async16(smem_u32(dst + r * ld + c), ok ? src + (size_t)r * D + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, Tf32Flash<D>::kMinBlocks)
attention_flash_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int H,
                     int Lq, int Lk, float scale_log2) {
  using T = Tf32Flash<D>;
  constexpr int kKeys = T::kKeys, N = kKeys / 8;
  extern __shared__ __align__(16) float tsm[];
  auto stage = [&](int s) { return tsm + s * T::kStage; };  // K rows, V rows, the key bias

  const int bh = blockIdx.y, tid = threadIdx.x, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const float* k_bh = k + (size_t)bh * Lk * D;
  const float* v_bh = v + (size_t)bh * Lk * D;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const float scale = all_masked ? 0.f : scale_log2;

  auto issue = [&](int t) {  // tile t's copies and key bias into stage t % 2 (an empty group past the end)
    if (t < tiles) {
      float* st = stage(t % 2);
      const int k0 = t * kKeys, n = min(kKeys, Lk - k0);
      stage_f32_rows<D>(st, T::kLdK, k_bh + (size_t)k0 * D, n, kKeys);
      stage_f32_rows<D>(st + kKeys * T::kLdK, T::kLdV, v_bh + (size_t)k0 * D, n, kKeys);
      for (int j = tid; j < kKeys; j += blockDim.x)
        st[kKeys * (T::kLdK + T::kLdV) + j] = key_bias(mask_b, k0 + j, Lk, all_masked);
    }
    cp_async_commit();
  };
  issue(0);

  // The warp's Q rows g and g + 8 from row0, in registers for the whole
  // block: qf[kk] holds columns 8 kk + 2t and + 1 of both rows in Q.K^T's
  // permuted A layout ({row g, row g + 8} x {2t, 2t + 1}); zero past Lq.
  const int row0 = blockIdx.x * kRows + tid / 32 * kWarpRows;
  const bool live = row0 < Lq;
  float qf[D / 8][4];
  {
    const float* q_bh = q + (size_t)bh * Lq * D;
    const bool v0 = row0 + g < Lq, v1 = row0 + g + 8 < Lq;
    const float* r0 = q_bh + (size_t)(v0 ? row0 + g : 0) * D + 2 * t4;
    const float* r1 = q_bh + (size_t)(v1 ? row0 + g + 8 : 0) * D + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float2 a = v0 ? *reinterpret_cast<const float2*>(r0 + 8 * kk) : make_float2(0.f, 0.f);
      const float2 b = v1 ? *reinterpret_cast<const float2*>(r1 + 8 * kk) : make_float2(0.f, 0.f);
      qf[kk][0] = a.x;
      qf[kk][1] = b.x;
      qf[kk][2] = a.y;
      qf[kk][3] = b.y;
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // ... for every thread; tile t - 1's stage is free
    issue(t + 1);
    if (!live) continue;
    const float* sk = stage(t % 2);
    const float* sv = sk + kKeys * T::kLdK;
    const float* bias = sv + kKeys * T::kLdV;

    float sc[N][4];  // S = Q K^T: sc[n] the m16n8 accumulator of keys 8n..8n+7
#pragma unroll
    for (int n = 0; n < N; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32_here(qf[kk][j], ah[j], al[j]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(sk + (8 * n + g) * T::kLdK + 8 * kk + 2 * t4);
        uint32_t bh2[2], bl2[2];
        split_tf32(x.x, bh2[0], bl2[0]);
        split_tf32(x.y, bh2[1], bl2[1]);
        mma_3xtf32(sc[n], ah, al, bh2, bl2);
      }
    }

    // Online softmax (flash_softmax's): s * scale + bias, the rows'
    // new max and sum, p = 2^(s - max), the output rescaled.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = fmaf(sc[n][e], scale, e % 2 ? bb.y : bb.x);
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - mu[r]);  // 0 while m is -inf
      l[r] *= alpha;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * r] *= alpha;
        o[dn][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - mu[e / 2]);
        l[e / 2] += sc[n][e];
      }

    // O += P V: k8 step kk takes keys 8 kk + 2t and + 1 (the permuted depth),
    // which sc[kk] holds: its accumulator is the step's A operand. The tile's
    // keys go in groups of 32 (4 steps): each 8-column group sums a key
    // group in an accumulator of its own, then adds it to o by a float32
    // add. Summed on the tensor cores in o itself, over thousands of keys,
    // the output drifted past the 1e-5 bar (1.45e-5 at 3681 keys, PERF.md):
    // their float32 accumulation is less exact than an FADD's rounding. A
    // group's split p is 32 registers whatever D.
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 4) {
      uint32_t pah[4][4], pal[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_tf32(sc[k0 + kk][0], pah[kk][0], pal[kk][0]);  // row g, key 2t
        split_tf32(sc[k0 + kk][2], pah[kk][1], pal[kk][1]);  // row g + 8, key 2t
        split_tf32(sc[k0 + kk][1], pah[kk][2], pal[kk][2]);  // row g, key 2t + 1
        split_tf32(sc[k0 + kk][3], pah[kk][3], pal[kk][3]);  // row g + 8, key 2t + 1
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float* vr = sv + (8 * k0 + 2 * t4) * T::kLdV + 8 * dn + g;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bh2[2], bl2[2];
          split_tf32(vr[8 * kk * T::kLdV], bh2[0], bl2[0]);
          split_tf32(vr[(8 * kk + 1) * T::kLdV], bh2[1], bl2[1]);
          mma_3xtf32(acc, pah[kk], pal[kk], bh2, bl2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] += acc[e];
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float sum = quad_sum(l[r]), inv = 1.f / sum;
    if (row >= Lq) continue;
    float* orow = out + ((size_t)bh * Lq + row) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(orow + 8 * dn) = make_float2(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    if (lse != nullptr && t4 == 0) lse[(size_t)bh * Lq + row] = (m[r] + log2f(sum)) * kLn2;
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
// Two launches, deterministic (no atomics). The dQ kernel: one block per
// query block of a (batch*head), walking K/V tiles through a ring; first it
// writes, for its rows, lse in base 2 (+inf past Lq, so that padded rows get
// P = 0) and D to a float32 scratch of Lq rounded up to its row blocks
// (scratch_rows: 128 for the bf16 Hopper pair at 64 and up, 64 otherwise).
// Then the dK/dV kernel: one block per key block, which keeps its K, V and
// key bias and walks tiles of Q, g and the scratch through a ring.
//
// What bounds it on an H100: seven products of 2 Lq Lk D flops over the
// valid keys (QK^T and gV^T in both kernels, dS K, P^T g, dS^T Q), 10 flops a
// query-key-dim counting the recomputed two once, on the tensor cores in
// bf16, against the bytes of q, k, v, out, g, dq, dk, dv: operations. At the
// training encoder (8,8,1008,1008,32) 29 GFLOP and 130 M exponentials (P in
// both kernels) against 33 MB.
//
// bf16 runs Hopper bodies (wgmma, TMA): a product's float32 accumulator is
// rounded to bf16 and repacked in registers as the A operand of the next
// (dS for dS K; P and dS for P^T g and dS^T Q), and the dK/dV kernel
// computes S^T = K Q^T, so that P^T comes out in the layout pack_a turns
// into an A operand. At head dims 64, 128, 192 and 256 the pair runs the
// bodies of the section after this one (128-row blocks), at 16 and 32 the
// narrow ones of the section after that (64-row blocks), and above 256
// the wgmma pair on column panels (after the forwards' panel section).
// float32 runs the
// 3xTF32 pair attention_bwd_{dq,dkdv}_tf32 up to 128 (mma.sync m16n8k8, its
// section after the Hopper bodies) and the register-tiled pair
// attention_bwd_{dq,dkdv}_fma above 128 (CUDA cores).

static_assert(kRows == kFlashWarps * kWarpRows && kRows == kTileKeys && kRows == kFlashKeys,
              "the backward's row and key tiles are 64 in both types");

// The bf16 pair of a fragment register as floats (lower column in .x).
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
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

// The producer's work for ring tile t of K2 or the dQ kernel (layout L,
// kKeys keys a tile), done by one warp: at D 192 and 256 warp 0 of a
// 256-thread block in line, at D 16 and 32 the narrow bodies' producer
// warp. Wait until tile t - kStages has been consumed, write tile t's key
// bias, then start its K and V loads (lane 0; in D / 64 column panels, or
// below 64 columns the whole row as one box; the other lanes arrive on full
// once their bias values are written).
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
    for (int h = 0; h < (D < kPanel ? 1 : D / kPanel); ++h) {
      tma_load(sm.base + L::kA + s * L::kTile + h * kKeys * 128, &tk, h * kPanel, t * kKeys, bh, full);
      tma_load(sm.base + L::kB + s * L::kTile + h * kKeys * 128, &tv, h * kPanel, t * kKeys, bh, full);
    }
  } else {
    mbar_arrive(full);
  }
}

// ============================ bf16 at head dims 16 and 32 (wgmma, TMA; DETR's)
// K2 and B.4's pair at DETR's head dims (32 at full size: 8 heads of 32;
// 16 in the tiny and small models) on the producer-warp skeleton above:
// consumer warpgroups of 64 rows, a producer warp that keeps the TMA busy
// through a ring of full and empty mbarriers, S = Q K^T (dP = g V^T) and
// the products after it on wgmma.m64nNk16, P (dS) rounded to bf16 and
// repacked in registers as the next product's A operand. What differs:
//  * A bf16 row of D values is 64 bytes at D = 32 and 32 bytes at D = 16,
//    so the TMA writes the tiles in the 64-byte and the 32-byte swizzle
//    (head_map: the box is the row, the swizzle span the row's bytes) and
//    the descriptors name those layouts (gmma_desc_narrow): K-major for the
//    score products (8-row atoms of 512 / 256 bytes, a k16 step 32 bytes on
//    in the row), MN-major for the products over keys or queries, whose N
//    is the whole row (one span of the swizzle).
//  * What bounds them is the exponentials, not the products: at DETR-R50's
//    encoder (8, 8, 920, 920, 32) 54 M of them, which the SFUs issue at 16
//    an SM a clock (0.0130 ms on an H100 SXM5's 132 SMs at its maximum
//    1980 MHz), against 0.0070 ms of products at 989 TFLOP/s (the training
//    pair: 130 M, 0.031 ms, against 0.029).
//    So K2 overlaps the softmax with the tensor cores inside a warpgroup,
//    as FlashAttention-3 does: it issues tile t's S = Q K^T and tile t-1's
//    O += P V together, waits for S alone, and computes tile t's softmax
//    while P.V runs; once P.V has landed, O takes its factor alpha and P
//    is repacked (not before: writing P's registers while P.V reads them
//    makes ptxas serialize every wgmma of the body, its warning C7513).
//    And the blocks are sized for several an SM, so that one warpgroup's
//    exponentials overlap another's products: 64-key (64-query) ring
//    tiles, whose score tile is 32 floats a thread.
//  * K2's rows a block follow Lq: two warpgroups (128 rows, K / V loaded
//    once for both, 288 threads, two blocks an SM) above kNarrowOneWgUpto
//    rows, one (64 rows, 160 threads, three blocks an SM) at or below it,
//    so that the calls with 100 queries (DETR's decoder) give 2 B H blocks
//    and not B H (64 at B 8, H 8, for 132 SMs). Paired on an H100, the
//    two-warpgroup blocks took 0.0371 ms at DETR-R50's encoder (8, 8, 920,
//    920, 32) and 0.1278 at DC5's (2, 8, 3680, 3680, 32), against 0.0429
//    and 0.1601 for one warpgroup (kNarrowOneWgUpto set to 4096 and timed
//    by attention_kernel_bench --against the unchanged source).
//  * The pair's kernels are one warpgroup a block at every length (three
//    blocks an SM, 128 registers): with two (one block an SM, since at two
//    ptxas left them 96 registers and both spilled) the training encoder's
//    pair (8, 8, 1008, 1008, 32) took 0.1172 ms against 0.0969, and the
//    100-query ones were no faster. Its scratch rows are 64 (scratch_rows).
constexpr int kNarrowOneWgUpto = 192;

template <int D> struct Narrow {
  static_assert(D == 16 || D == 32, "the narrow bodies take head dims 16 and 32");
  static constexpr int kRow = 2 * D;      // bytes of a bf16 row: the swizzle span
  static constexpr int kAtom = 8 * kRow;  // 8 rows: 512 or 256 bytes
  // The k16 step kk of rows [r0, r0 + 64) of a tile (K-major).
  __device__ __forceinline__ static uint64_t desc_k(uint32_t tile, int r0, int kk) {
    return gmma_desc_narrow<kRow>(tile + r0 * kRow + kk * 32, 16, kAtom);
  }
  // Rows [16 kk, 16 kk + 16) of a tile as the depth of a product over its D
  // columns (MN-major).
  __device__ __forceinline__ static uint64_t desc_mn(uint32_t tile, int kk) {
    return gmma_desc_narrow<kRow>(tile + kk * 16 * kRow, kAtom, kAtom);
  }
};

// Shared memory of the narrow bodies, byte offsets from a 1024-byte aligned
// base: kFixed tiles of 64 kWG rows (K2: Q; dQ: Q, g; dK/dV: K, V), the
// ring's kStages stages of two kRing-row tiles, kVecs float vectors of kRing
// a stage (K2, dQ: the key bias; dK/dV: lse2 and D) and the mbarriers
// (fixed, full[s], empty[s]).
template <int D, int kWG, int kFixed, int kVecs> struct NarrowLayout {
  static constexpr int kRing = 64, kStages = 4;
  static constexpr int kRows = 64 * kWG;  // rows of a fixed tile: the block's queries (dK/dV: keys)
  static constexpr uint32_t kFix = kRows * 2 * D;
  static constexpr uint32_t kTile = kRing * 2 * D;
  static constexpr uint32_t kA = kFixed * kFix;
  static constexpr uint32_t kB = kA + kStages * kTile;
  static constexpr uint32_t kVec = kB + kStages * kTile;
  static constexpr uint32_t kBar = kVec + kStages * kVecs * kRing * 4;
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kFix % 1024 == 0 && kTile % 1024 == 0, "swizzle atoms are aligned to their size");
};

// The mbarriers of a narrow layout L: the fixed tiles' (one arrival), then
// full[s] (full_count arrivals) and empty[s] (empty_count) of each stage.
template <typename L>
__device__ __forceinline__ void init_narrow_barriers(uint32_t bar, int full_count, int empty_count) {
  mbar_init(bar, 1);
  for (int s = 0; s < L::kStages; ++s) {
    mbar_init(bar + 8 * (1 + s), full_count);
    mbar_init(bar + 8 * (1 + L::kStages + s), empty_count);
  }
  mbar_init_fence();
}

// Threads of a narrow block, and the blocks an SM its registers are sized
// for. The register file is split over the SM's four quadrants, so a
// thread's share is that of the most warps one quadrant holds: three
// 160-thread blocks (15 warps, 4 a quadrant) leave 128 registers, two
// 288-thread ones (18 warps, 5) 96.
constexpr int narrow_threads(int kWG) { return kWgThreads * kWG + 32; }
constexpr int narrow_blocks(int kWG) { return kWG == 1 ? 3 : 2; }
// K2's consumer warpgroups a block over Lq query rows.
inline int narrow_wg(int Lq) { return Lq <= kNarrowOneWgUpto ? 1 : 2; }

// ------------------------------------------------------ K2, narrow wgmma
template <int D, int kWG>
__global__ void __launch_bounds__(narrow_threads(kWG), narrow_blocks(kWG))
attention_flash_wgmma_narrow(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                             bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                             float scale_log2) {
  using N = Narrow<D>;
  using L = NarrowLayout<D, kWG, 1, 1>;
  constexpr int kKeys = L::kRing, kConsumers = kWgThreads * kWG;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_q = sm.base, bar_q = sm.base + L::kBar;
  auto s_k = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_v = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto bias = [&](int s) { return reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = blockIdx.y * L::kRows, bh = blockIdx.x, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  // full: the producer warp's lanes, each after its bias values
  if (tid == 0) init_narrow_barriers<L>(bar_q, 32, kConsumers);
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the init

  if (tid >= kConsumers) {  // the producer warp
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kFix);
      tma_load(s_q, &tq, 0, q0, bh, bar_q);
    }
    for (int t = 0; t < tiles; ++t) load_kv_tile<L, D, kKeys>(sm, t, lane, tk, tv, bh, mask_b, Lk, all_masked);
  } else {  // the consumers
    const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
    const float scale = all_masked ? 0.f : scale_log2;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[kKeys / 2];
    uint32_t pa[kKeys / 16][4];
    // S = Q K_t^T into sc (issued, not waited for).
    auto scores = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Gmma<kKeys>::template ss<0>(sc, N::desc_k(s_q, 64 * wc, kk), N::desc_k(s_k(s), 0, kk), kk);
      wgmma_commit();
    };
    // O += P V_t (issued, not waited for).
    auto pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) Gmma<D>::template rs<1>(o, pa[kk], N::desc_mn(s_v(s), kk));
      wgmma_commit();
    };
    mbar_wait(bar_q, 0);
    mbar_wait(full(0), 0);
    wgmma_fence();
    scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    flash_softmax<kKeys>(sc, bias(0), scale, m, l, alpha);
    pack_a<kKeys>(sc, pa);
    for (int t = 1; t < tiles; ++t) {
      const int s = t % L::kStages, sp = (t - 1) % L::kStages;
      mbar_wait(full(s), (t / L::kStages) & 1);
      wgmma_fence();
      scores(s);   // tile t's scores ...
      pv(sp);      // ... and tile t-1's P.V, on the tensor cores together
      wgmma_wait<1>();
      fence_regs(sc);
      flash_softmax<kKeys>(sc, bias(s), scale, m, l, alpha);  // while P.V runs
      wgmma_wait<0>();
      fence_regs(o);
      // Only now are P's registers free: writing them while P.V reads them
      // makes ptxas serialize every wgmma of the body (C7513).
      pack_a<kKeys>(sc, pa);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      mbar_arrive(empty(sp));
    }
    wgmma_fence();
    pv((tiles - 1) % L::kStages);
    wgmma_wait<0>();
    fence_regs(o);
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

// ------------------------------------------------------ dQ, narrow wgmma
template <int D>
__global__ void __launch_bounds__(narrow_threads(1), narrow_blocks(1))
attention_bwd_dq_wgmma_narrow(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                              const uint8_t* __restrict__ mask, const bf16* __restrict__ out,
                              const float* __restrict__ lse, const bf16* __restrict__ g, bf16* __restrict__ dq,
                              float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq, int Lk,
                              int Lq_pad, float scale_log2, float scale) {
  using N = Narrow<D>;
  using L = NarrowLayout<D, 1, 2, 1>;
  constexpr int kKeys = L::kRing, kConsumers = kWgThreads;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_q = sm.base, s_g = sm.base + L::kFix, bar_q = sm.base + L::kBar;
  auto s_k = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_v = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto bias = [&](int s) { return reinterpret_cast<float*>(sm.ptr + L::kVec) + s * kKeys; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = blockIdx.y * L::kRows, bh = blockIdx.x, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  if (tid == 0) init_narrow_barriers<L>(bar_q, 32, kConsumers);
  const bool all_masked = !any_valid_key(mask_b, Lk);

  if (tid >= kConsumers) {  // the producer warp, as K2's
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * L::kFix);
      tma_load(s_q, &tq, 0, q0, bh, bar_q);
      tma_load(s_g, &tg, 0, q0, bh, bar_q);
    }
    for (int t = 0; t < tiles; ++t) load_kv_tile<L, D, kKeys>(sm, t, lane, tk, tv, bh, mask_b, Lk, all_masked);
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
        Gmma<kKeys>::template ss<0>(sc, N::desc_k(s_q, 64 * wc, kk), N::desc_k(s_k(s), 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Gmma<kKeys>::template ss<0>(dp, N::desc_k(s_g, 64 * wc, kk), N::desc_k(s_v(s), 0, kk), kk);
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
      for (int kk = 0; kk < kKeys / 16; ++kk) Gmma<D>::template rs<1>(acc, da[kk], N::desc_mn(s_k(s), kk));
      wgmma_commit();  // dQ += dS K
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }
    const float sc2[2] = {scale, scale};
    store_acc<D>(acc, sc2, dq + q_off, row0, Lq);
  }
}

// --------------------------------------------------- dK/dV, narrow wgmma
template <int D>
__global__ void __launch_bounds__(narrow_threads(1), narrow_blocks(1))
attention_bwd_dkdv_wgmma_narrow(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                                const uint8_t* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv,
                                const float* __restrict__ lse2_pad, const float* __restrict__ dsum_pad, int H,
                                int Lq, int Lk, int Lq_pad, float scale_log2, float scale) {
  using N = Narrow<D>;
  using L = NarrowLayout<D, 1, 2, 2>;
  constexpr int kQRows = L::kRing, kConsumers = kWgThreads;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const uint32_t s_k = sm.base, s_v = sm.base + L::kFix, bar_kv = sm.base + L::kBar;
  auto s_q = [&](int s) { return sm.base + L::kA + s * L::kTile; };
  auto s_g = [&](int s) { return sm.base + L::kB + s * L::kTile; };
  auto vec = [&](int s) { return sm.base + L::kVec + s * 2 * kQRows * 4; };  // lse2, then D
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + L::kStages + s); };

  const int k0 = blockIdx.y * L::kRows, bh = blockIdx.x, tid = threadIdx.x;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = Lq_pad / kQRows;
  const size_t pad_off = (size_t)bh * Lq_pad;
  if (tid == 0) init_narrow_barriers<L>(bar_kv, 1, kConsumers);
  const bool all_masked = !any_valid_key(mask_b, Lk);

  if (tid >= kConsumers) {  // the producer warp: K and V once, then Q, g, lse2 and D a query tile
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kFix);
      tma_load(s_k, &tk, 0, k0, bh, bar_kv);
      tma_load(s_v, &tv, 0, k0, bh, bar_kv);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % L::kStages, r0 = t * kQRows;
        if (t >= L::kStages) mbar_wait(empty(s), (t / L::kStages - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kTile + 2 * kQRows * 4);
        tma_load(s_q(s), &tq, 0, r0, bh, full(s));
        tma_load(s_g(s), &tg, 0, r0, bh, full(s));
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
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(bar_kv, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % L::kStages;
      mbar_wait(full(s), (t / L::kStages) & 1);
      float p[kQRows / 2], ds[kQRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T (unscaled): this warpgroup's keys x the tile's queries
        Gmma<kQRows>::template ss<0>(p, N::desc_k(s_k, 64 * wc, kk), N::desc_k(s_q(s), 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V g^T
        Gmma<kQRows>::template ss<0>(ds, N::desc_k(s_v, 64 * wc, kk), N::desc_k(s_g(s), 0, kk), kk);
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
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) Gmma<D>::template rs<1>(dva, pa[kk], N::desc_mn(s_g(s), kk));
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) Gmma<D>::template rs<1>(dka, da[kk], N::desc_mn(s_q(s), kk));
      wgmma_commit();  // dV += P^T g, dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(empty(s));
    }
    const size_t kv_off = (size_t)bh * Lk * D;
    const float sc[2] = {scale, scale}, one[2] = {1.f, 1.f};
    store_acc<D>(dka, sc, dk + kv_off, key0, Lk);
    store_acc<D>(dva, one, dv + kv_off, key0, Lk);
  }
}

// ------------------------------------------ K2 and dQ at D 192 and 256, wgmma
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

// ===================== B.4's pair in float32 up to head dim 128 (3xTF32)
// The float32 pair at head dims 16, 32, 64 and 128 (and those padded to
// them) on the tensor cores, at float32's accuracy: each of its five
// products is three TF32 products (3xTF32, as float32 K2: split_tf32,
// mma_tf32, mma_3xtf32 above), on mma.sync.m16n8k8.
//  * The scheme is that of the bf16 mma.sync pair it was built from:
//    4 warps a block, a warp 16 query rows (dQ) or 16 keys (dK/dV), the
//    streamed operand in kTile-row tiles through two cp.async stages (the
//    next tile loading under the current one's products). The dQ kernel
//    recomputes S = Q K^T and dP = dO V^T for its 64 rows and each key
//    tile, then dQ += dS K; first it writes lse2 and D for its rows to the
//    scratch. The dK/dV kernel recomputes S^T = K Q^T and dP^T = V dO^T for
//    its 64 keys and each query tile, then dV += P^T dO and dK += dS^T Q.
//  * What a block keeps (its 64 rows of Q and dO, or of K and V) stays in
//    shared memory, not in registers: the A fragments of the recomputed
//    products are read from there in each tile, so a thread holds only its
//    outputs (dQ: D / 2 floats; dK and dV: kOut / 2 each) and one group of
//    scores. Its split into hi and lo is done where it is read, as K2
//    splits Q in each tile.
//  * P, P^T, dS and dS^T leave their products as m16n8 accumulators (rows
//    g and g + 8, columns 2t and 2t + 1). The depth of each k8 step of the
//    products they feed is permuted as K2's P.V is (logical t and t + 4 are
//    keys or query rows 2t and 2t + 1), so an accumulator is the next
//    product's A operand with no shuffle, and its B operand (K, dO or Q,
//    read down a column) is two 32-bit loads at rows 2t and 2t + 1. In the
//    recomputed products the depth is the head dim, permuted as in K2's
//    Q.K^T: each B value pair is one 64-bit load.
//  * Every staged row is D + 8 floats: a warp's 64-bit loads (8 rows x 4
//    column pairs) then meet every bank once; its 32-bit loads down a
//    column (rows 2t, 2t + 1) meet each bank twice (D + 4 would serve those
//    and not the 64-bit ones; one stride serves both products of a tile).
//  * The sums over keys (dQ) and over query rows (dK, dV) run to thousands:
//    each group of kGroup keys or rows (32; a whole 16-row tile at D 128)
//    sums in an accumulator of its own, added to the output by a float32
//    add, as K2's P.V (its drift on the tensor cores' accumulation).
//  * S in the dQ kernel is the forward's (attention_flash_tf32) to the
//    bit: the same split of the same Q and K values, the same three
//    products in the same order, the head dim in the same k8 order, and
//    s * scale + bias by the same fmaf. The dK/dV kernel takes the products
//    in that order too, with K and Q in each other's places.
//  * Tiles: 64 keys or rows at D 16 and 32, 32 at 64, 16 at 128, so that
//    the block's shared memory (its own 64 rows of two operands and two
//    stages of two tiles) lets three blocks an SM up to D 64 and two at
//    128. At D 128 the dK/dV kernel takes its output in two 64-column
//    halves on grid z (kOut), each recomputing S^T and dP^T: one block of
//    all 128 columns holds 128 floats of dK and dV a thread (255 registers)
//    and ran 1.25x slower, on half the blocks (PERF.md).
//  * Bound: operations on the tensor cores, 10 flops a query-key-dim (the
//    five products over the valid keys) at 165 TFLOP/s of float32 work
//    (three TF32 products at 495); at (2, 12, 1008, 1008, 64) 15.6 GFLOP,
//    0.095 ms.
template <int D> struct Tf32Pair {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  static constexpr int kLd = D + 8;                                // row stride of every staged tile (floats)
  static constexpr int kTile = D <= 32 ? 64 : D == 64 ? 32 : 16;   // keys (dQ) or query rows (dK/dV) a ring tile
  static constexpr int kGroup = kTile < 32 ? kTile : 32;           // keys or rows summed in one accumulator
  static constexpr int kOut = D == 128 ? 64 : D;                  // dK/dV output columns a block (grid z)
  static constexpr int kFixed = 2 * kRows * kLd + 2 * kRows;       // floats: the block's 64 rows of two operands, 2 vectors
  static constexpr int kStage = 2 * kTile * kLd + 2 * kTile;       // floats: a tile of two operands, 2 vectors
  static constexpr size_t kSmem = (size_t)(kFixed + 2 * kStage) * sizeof(float);
  // Blocks an SM (launch bounds): three where their registers allow it
  // without a spill (ptxas, CUDA 12.8: the dK/dV kernel at D 64 spilled 44
  // bytes a thread in 168 registers), else two.
  static constexpr int kMinBlocksDq = D <= 64 ? 3 : 2;
  static constexpr int kMinBlocksDkdv = D <= 32 ? 3 : 2;
  static_assert(D % kOut == 0 && kOut % 8 == 0 && kRows % kTile == 0, "column blocks and tiles divide evenly");
};
static_assert(3 * (Tf32Pair<64>::kSmem + 1024) <= 233472 && 2 * (Tf32Pair<128>::kSmem + 1024) <= 233472,
              "the blocks an SM of the launch bounds fit its shared memory");

// d += a b in 3xTF32 with a and b in each other's places: the hi lo, lo hi,
// hi hi order of mma_3xtf32(d, b, a), so that K Q^T sums the terms of
// Q K^T in the same order.
__device__ __forceinline__ void mma_3xtf32_swapped(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                                   const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, ah, bl);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bh);
}

// The A fragment of k8 step kk of a warp's 16 staged rows (row g at r, row
// g + 8 at r + 8 ld), columns 8 kk + 2t and + 1, split: the permuted layout
// of K2's Q.
__device__ __forceinline__ void split_rows(const float* r, int ld, int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(r + 8 * kk);
  const float2 b = *reinterpret_cast<const float2*>(r + 8 * ld + 8 * kk);
  split_tf32(a.x, h[0], l[0]);
  split_tf32(b.x, h[1], l[1]);
  split_tf32(a.y, h[2], l[2]);
  split_tf32(b.y, h[3], l[3]);
}

// An m16n8 accumulator as the A fragment of the next product's k8 step
// (depth: its columns 2t and 2t + 1), split.
__device__ __forceinline__ void split_acc(const float (&c)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
  split_tf32(c[0], h[0], l[0]);  // row g, column 2t
  split_tf32(c[2], h[1], l[1]);  // row g + 8, column 2t
  split_tf32(c[1], h[2], l[2]);  // row g, column 2t + 1
  split_tf32(c[3], h[3], l[3]);  // row g + 8, column 2t + 1
}

// s[n] += A B^T for the warp's 16 rows of A (a: row g of them, staged) and
// the 8N rows of B from b0 (n: rows 8n .. 8n + 7), over the head dim,
// 3xTF32 (swapped: the order with A and B in each other's places).
template <int D, int N, bool kSwapped>
__device__ __forceinline__ void tf32_scores(const float* a, const float* b0, float (&s)[N][4]) {
  constexpr int kLd = Tf32Pair<D>::kLd;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_rows(a, kLd, kk, ah, al);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(b0 + (8 * n + g) * kLd + 8 * kk + 2 * t);
      uint32_t bh[2], bl[2];
      split_tf32(x.x, bh[0], bl[0]);
      split_tf32(x.y, bh[1], bl[1]);
      if constexpr (kSwapped) mma_3xtf32_swapped(s[n], ah, al, bh, bl);
      else mma_3xtf32(s[n], ah, al, bh, bl);
    }
  }
}

// o[dn] += C B over the kOut / 8 column groups of B from b0 (row 0 of the
// group's 8N depth rows, column c0): c[kk] the accumulator whose columns are
// depth rows 8 kk + 2t and + 1. The group sums in an accumulator of its
// own, added to o by a float32 add.
template <int D, int N, int kOut>
__device__ __forceinline__ void tf32_accumulate(const float (&c)[N][4], const float* b0, float (&o)[kOut / 8][4]) {
  constexpr int kLd = Tf32Pair<D>::kLd;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t ch[N][4], cl[N][4];
#pragma unroll
  for (int kk = 0; kk < N; ++kk) split_acc(c[kk], ch[kk], cl[kk]);
#pragma unroll
  for (int dn = 0; dn < kOut / 8; ++dn) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* br = b0 + 2 * t * kLd + 8 * dn + g;
#pragma unroll
    for (int kk = 0; kk < N; ++kk) {
      uint32_t bh[2], bl[2];
      split_tf32(br[8 * kk * kLd], bh[0], bl[0]);
      split_tf32(br[(8 * kk + 1) * kLd], bh[1], bl[1]);
      mma_3xtf32(acc, ch[kk], cl[kk], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] += acc[e];
  }
}

// --------------------------------------------------------------- dQ, float32
template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, Tf32Pair<D>::kMinBlocksDq)
attention_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const uint8_t* __restrict__ mask, const float* __restrict__ out, const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ dq, float* __restrict__ lse2_pad,
                      float* __restrict__ dsum_pad, int H, int Lq, int Lk, int Lq_pad, float scale_log2, float scale) {
  using P = Tf32Pair<D>;
  constexpr int kKeys = P::kTile, kLd = P::kLd, N = P::kGroup / 8;
  extern __shared__ __align__(16) float psm[];
  float* sq = psm;                  // the block's 64 rows of Q
  float* sg = sq + kRows * kLd;     // ... and of dO
  float* sl = sg + kRows * kLd;     // lse2 of those rows
  float* sd = sl + kRows;           // D of those rows
  auto stage = [&](int s) { return psm + P::kFixed + s * P::kStage; };  // K rows, V rows, the key bias

  const int bh = blockIdx.y, tid = threadIdx.x, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * kRows, nq = min(kRows, Lq - q0);
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const float* k_bh = k + (size_t)bh * Lk * D;
  const float* v_bh = v + (size_t)bh * Lk * D;
  const size_t q_off = ((size_t)bh * Lq + q0) * D;
  const int tiles = (Lk + kKeys - 1) / kKeys;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const float scale_p = all_masked ? 0.f : scale_log2;

  stage_f32_rows<D>(sq, kLd, q + q_off, nq, kRows);
  stage_f32_rows<D>(sg, kLd, g + q_off, nq, kRows);
  cp_async_commit();
  auto issue = [&](int t) {  // key tile t's copies and key bias into stage t % 2 (an empty group past the end)
    if (t < tiles) {
      float* st = stage(t % 2);
      const int k0 = t * kKeys, n = min(kKeys, Lk - k0);
      stage_f32_rows<D>(st, kLd, k_bh + (size_t)k0 * D, n, kKeys);
      stage_f32_rows<D>(st + kKeys * kLd, kLd, v_bh + (size_t)k0 * D, n, kKeys);
      for (int j = tid; j < kKeys; j += blockDim.x) st[2 * kKeys * kLd + j] = key_bias(mask_b, k0 + j, Lk, all_masked);
    }
    cp_async_commit();
  };
  issue(0);

  // D = rowsum(dO * O) and lse in base 2 of the block's rows, two threads a
  // row (each half the head dim), into shared memory for the warps and into
  // the scratch for the dK/dV kernel; rows past Lq get D = 0 and lse2 = +inf
  // (P = 0), and the scratch's rows up to Lq_pad are all written.
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  {
    const int r = tid / 2, h = tid % 2, row = q0 + r;
    float part = 0.f;
    if (row < Lq) {
      const float* orow = out + ((size_t)bh * Lq + row) * D + h * (D / 2);
      const float* grow = sg + r * kLd + h * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(orow + c);
        const float4 b = *reinterpret_cast<const float4*>(grow + c);
        part = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, part))));
      }
    }
    const float dsum = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if (h == 0) {
      const float l2 = row < Lq ? lse[(size_t)bh * Lq + row] * kLog2e : INFINITY;
      sl[r] = l2;
      sd[r] = dsum;
      lse2_pad[(size_t)bh * Lq_pad + row] = l2;
      dsum_pad[(size_t)bh * Lq_pad + row] = dsum;
    }
  }
  __syncthreads();

  const int wr = tid / 32 * kWarpRows;  // the warp's first row in the block
  const bool live = q0 + wr < Lq;
  const float* wq = sq + (wr + gq) * kLd + 2 * t4;
  const float* wg = sg + (wr + gq) * kLd + 2 * t4;
  const float lse2[2] = {sl[wr + gq], sl[wr + gq + 8]}, dsum[2] = {sd[wr + gq], sd[wr + gq + 8]};
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();  // key tile t has landed
    __syncthreads();     // ... for every thread; tile t - 1's stage is free
    issue(t + 1);
    if (!live) continue;
    const float* sk = stage(t % 2);
    const float* sv = sk + kKeys * kLd;
    const float* bias = sv + kKeys * kLd;
#pragma unroll 1
    for (int k0 = 0; k0 < kKeys; k0 += P::kGroup) {
      float s[N][4], dp[N][4];
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      tf32_scores<D, N, false>(wq, sk + k0 * kLd, s);   // S = Q K^T, the forward's
      tf32_scores<D, N, false>(wg, sv + k0 * kLd, dp);  // dP = dO V^T
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + k0 + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // dS = P (dP - D), P = 2^(s scale + bias - lse2)
          s[n][e] = exp2f(fmaf(s[n][e], scale_p, e % 2 ? bb.y : bb.x) - lse2[e / 2]) * (dp[n][e] - dsum[e / 2]);
      }
      tf32_accumulate<D, N, D>(s, sk + k0 * kLd, o);  // dQ += dS K
    }
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gq + 8 * r;
    if (row >= Lq) continue;
    float* drow = dq + ((size_t)bh * Lq + row) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(drow + 8 * dn) = make_float2(o[dn][2 * r] * scale, o[dn][2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------ dK/dV, float32
template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, Tf32Pair<D>::kMinBlocksDkdv)
attention_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const uint8_t* __restrict__ mask, const float* __restrict__ g, float* __restrict__ dk,
                        float* __restrict__ dv, const float* __restrict__ lse2_pad,
                        const float* __restrict__ dsum_pad, int H, int Lq, int Lk, int Lq_pad, float scale_log2,
                        float scale) {
  using P = Tf32Pair<D>;
  constexpr int kQ = P::kTile, kLd = P::kLd, kOut = P::kOut, N = P::kGroup / 8;
  extern __shared__ __align__(16) float psm[];
  float* sk = psm;                // the block's 64 keys' rows of K
  float* sv = sk + kRows * kLd;   // ... and of V
  auto stage = [&](int s) { return psm + P::kFixed + s * P::kStage; };  // Q rows, dO rows, lse2, D

  const int bh = blockIdx.y, tid = threadIdx.x, lane = tid % 32, gk = lane / 4, t4 = lane % 4;
  const int key0 = blockIdx.x * kRows, c0 = blockIdx.z * kOut;  // the block's keys and first output column
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const size_t q_off = (size_t)bh * Lq * D, kv_off = ((size_t)bh * Lk + key0) * D, pad_off = (size_t)bh * Lq_pad;
  const int tiles = (Lq + kQ - 1) / kQ;
  const bool all_masked = !any_valid_key(mask_b, Lk);
  const float scale_p = all_masked ? 0.f : scale_log2;

  stage_f32_rows<D>(sk, kLd, k + kv_off, min(kRows, Lk - key0), kRows);
  stage_f32_rows<D>(sv, kLd, v + kv_off, min(kRows, Lk - key0), kRows);
  cp_async_commit();
  // Query tile t's copies into stage t % 2: Q and dO rows (zero past Lq),
  // and their lse2 and D, kQ / 4 chunks of 16 bytes each (the scratch is
  // padded to 64 rows, a multiple of kQ).
  auto issue = [&](int t) {
    if (t < tiles) {
      float* st = stage(t % 2);
      const int r0 = t * kQ, n = min(kQ, Lq - r0);
      stage_f32_rows<D>(st, kLd, q + q_off + (size_t)r0 * D, n, kQ);
      stage_f32_rows<D>(st + kQ * kLd, kLd, g + q_off + (size_t)r0 * D, n, kQ);
      if (tid < kQ / 2) {
        const bool is_lse = tid < kQ / 4;
        const int c = 4 * (tid % (kQ / 4));
        cp_async16(smem_u32(st + 2 * kQ * kLd + (is_lse ? 0 : kQ) + c), (is_lse ? lse2_pad : dsum_pad) + pad_off + r0 + c,
                   true);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const int wk = tid / 32 * kWarpRows;  // the warp's first key in the block
  const bool live = key0 + wk < Lk;
  const float kbias[2] = {key_bias(mask_b, key0 + wk + gk, Lk, all_masked),
                          key_bias(mask_b, key0 + wk + gk + 8, Lk, all_masked)};
  const float* wkr = sk + (wk + gk) * kLd + 2 * t4;
  const float* wvr = sv + (wk + gk) * kLd + 2 * t4;
  float dka[kOut / 8][4], dva[kOut / 8][4];
#pragma unroll
  for (int dn = 0; dn < kOut / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();  // query tile t (and, first, K and V) has landed
    __syncthreads();     // ... for every thread; tile t - 1's stage is free
    issue(t + 1);
    if (!live) continue;
    const float* sq = stage(t % 2);
    const float* sg = sq + kQ * kLd;
    const float* sl = sg + kQ * kLd;
    const float* sd = sl + kQ;
#pragma unroll 1
    for (int r0 = 0; r0 < kQ; r0 += P::kGroup) {
      float s[N][4], dp[N][4];  // S^T and dP^T: the warp's keys (rows) x the group's queries (columns)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      tf32_scores<D, N, true>(wkr, sq + r0 * kLd, s);   // S^T = K Q^T
      tf32_scores<D, N, true>(wvr, sg + r0 * kLd, dp);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + r0 + 8 * n + 2 * t4);
        const float2 dd = *reinterpret_cast<const float2*>(sd + r0 + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // e % 2: query 2t + e % 2; e / 2: key row g or g + 8
          s[n][e] = exp2f(fmaf(s[n][e], scale_p, kbias[e / 2]) - (e % 2 ? l2.y : l2.x));
          dp[n][e] = s[n][e] * (dp[n][e] - (e % 2 ? dd.y : dd.x));
        }
      }
      tf32_accumulate<D, N, kOut>(s, sg + r0 * kLd + c0, dva);   // dV += P^T dO
      tf32_accumulate<D, N, kOut>(dp, sq + r0 * kLd + c0, dka);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + wk + gk + 8 * r;
    if (key >= Lk) continue;
    const size_t at = ((size_t)bh * Lk + key) * D + c0 + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < kOut / 8; ++dn) {
      *reinterpret_cast<float2*>(dk + at + 8 * dn) = make_float2(dka[dn][2 * r] * scale, dka[dn][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + at + 8 * dn) = make_float2(dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
  }
}

// Query rows of the backward's scratch for one (batch*head): Lq rounded up
// to the dQ kernel's row block, 128 for the bf16 Hopper pairs at head dims
// 64 and up and 64 for every other body (the narrow bf16 pair at 16 and 32,
// the float32 3xTF32 pair and the register-tiled one above 128: 64-row dQ
// blocks, and dK/dV query tiles that divide 64). The one rule for it: the
// launchers pad by it, and the wrapper allocates by
// attention_backward_scratch_rows.
int scratch_rows(int dtype, int Lq, int D) {
  const int tile = dtype == 1 && D >= 64 ? kWgRows : kRows;
  return (Lq + tile - 1) / tile * tile;
}

// ================================= forwards above head dim 128, both types
// K1 in both types at every head dim above 128, K2 in float32 above 128 and
// in bf16 above 256 (bf16 K2 at 192 and 256 keeps
// attention_flash_wgmma_inline). The wrapper pads D to a multiple of 64
// (kernels/attention.py::kernel_head_dim). Two bodies on one plan: bf16 on
// the tensor cores (attention_panels_wgmma: wgmma, TMA) and float32 on the
// CUDA cores (attention_panels_fma: FP32 FMAs; one TF32 product would
// break the 1e-5 bar).
//  * Output panels. A block accumulates at most 256 output columns. Up to
//    256 that is the whole head (one block on grid z); above it the output
//    is cut into n = ceil(D / 256) panels on grid z of P = ceil(D / n / 16)
//    * 16 columns each (the last D - (n - 1) P: 320 -> 2 x 160, 384 -> 2 x
//    192, 640 -> 224, 224, 192), and a block accumulates kAcc = ceil(P / 64)
//    * 64 of them (192 or 256) and stores its P. Each z block recomputes all
//    of S = Q K^T over the whole head dim: at n panels the scores cost n
//    times what one block would spend (at D 320, 2 x 320 columns of Q.K^T
//    products and 2 x 192 of P.V a key, where 320 + 320 would do with no
//    split: 1.6x the products). panel_plan is the one rule;
//    kernels/attention.py::panel_forward_plan mirrors it and
//    attention_forward_plan exports it.
//  * A stream of items. A block walks one sequence of ring items: for each
//    64-key tile the scores' operands, then (K2, and K1's second pass) the
//    tile's V columns of the block's panel. While Q fits beside the ring
//    (D <= 256, one panel) it stays in shared memory for the whole block,
//    loaded once, and a tile's scores are one item, its K over all of D;
//    above 256 they are D / 64 items, each a 64-column chunk of Q and of K,
//    so that shared memory does not grow with D (Q is read again from L2 for
//    every key tile). K1 first walks every tile's score items once (pass 1:
//    each row's max and normaliser), then recomputes the scores and
//    normalises p before it rounds it (bf16) and multiplies it by V, as
//    _fused_attn_kernel does; K2 runs K2's online softmax. Shared memory is
//    independent of Lk, so K1 takes any Lk.
//  * bf16: two consumer warpgroups of 64 query rows (128 a block, 256
//    threads, 255 registers a thread: a 64 x 256 accumulator is 128 of
//    them), warp 0 the producer in line as in attention_flash_wgmma_inline:
//    it starts item i + kPanelStages once the block has consumed item i.
//    Items come by TMA (the 128-byte swizzle) into a ring of four slots of
//    kAcc / 64 x 8 KB; S = Q K^T by wgmma.m64n64k16 from shared memory, the
//    softmax in mma.sync's accumulator layout, p rounded to bf16 and
//    repacked in registers as the A operand of P.V (m64n64k16, V MN-major
//    from the slot). A separate template instance, not a flag on the in-line
//    K2 body: the panel offsets, the streamed Q and the two passes are
//    runtime paths that the D 192/256 K2 body does not carry, and ptxas
//    sized that body's 255 registers without them.
//  * float32: 64 query rows a block of 256 threads, a 16 x 16 grid of
//    threads: thread (ty, tx) owns the scores of rows ty + 16 i and keys
//    tx + 16 j (4 x 4) and the output of rows ty + 16 i and the float4
//    columns 4 tx + 64 c (4 x kAcc / 64 float4s). Operands come from shared
//    rows padded by 4 floats as float4s, at compile-time strides: 64 FMAs
//    for 8 shared loads in S, 256 for 20 in P.V (p goes through shared
//    memory, since a row's keys are spread over 16 threads). Items come by
//    16-byte cp.async into two slots, the next item loading under the
//    current one's products. It runs at about half the FP32 FMA rate; a
//    warp-tiled layout with a third fewer shared wavefronts in S and half
//    in P.V (rows 4 apart, a row's max and sum meeting across two warps in
//    shared memory) was no faster (PERF.md), so the wavefronts are not
//    what holds it.
//  * Bound: K1 at the VITW DETR's float32 (8, 4, 197, 197, 256) does 1.3
//    GFLOP of Q.K^T and P.V, 0.019 ms at 67 TFLOP/s of FP32 FMAs (K1's
//    second Q.K^T adds half of that again); bf16 K2 at (8, 4, 1008, 1008,
//    320) 5.2 GFLOP, 0.005 ms at 989 TFLOP/s, and with its two panels about
//    1.5x that.
constexpr int kPanelMax = 256;   // most output columns a block accumulates
constexpr int kPanelKeys = 64;   // keys a tile
constexpr int kPanelStages = 4;  // bf16: slots of the ring

struct PanelPlan {
  int panels;  // blocks on grid z
  int cols;    // output columns a block stores (the last block D - (panels - 1) cols)
  int acc;     // columns a block accumulates: 192 or 256
};
__host__ __device__ constexpr PanelPlan panel_plan(int D) {
  const int n = (D + kPanelMax - 1) / kPanelMax;
  const int cols = ((D + n - 1) / n + 15) / 16 * 16;
  return {n, cols, (cols + kPanel - 1) / kPanel * kPanel};
}

// Item i of a block's stream: tile t and, among the tile's nqk score
// items, c; c == nqk is the tile's V (the second pass). K1 walks the
// tiles' score items once before.
struct PanelItem {
  int t, c;
};
__device__ __forceinline__ PanelItem panel_item(int i, int tiles, int nqk, bool two_pass) {
  const int p1 = two_pass ? tiles * nqk : 0;
  if (i < p1) return {i / nqk, i % nqk};
  i -= p1;
  return {i / (nqk + 1), i % (nqk + 1)};
}
__device__ __forceinline__ int panel_items(int tiles, int nqk, bool two_pass) {
  return (two_pass ? tiles * nqk : 0) + tiles * (nqk + 1);
}

// ----------------------------------------------------- bf16, wgmma and TMA
// Shared memory, byte offsets from a 1024-byte aligned base: Q when it stays
// (kNp panels of 128 rows), the ring's slots of kNp x 64 keys x 128 B (a K
// tile over all of D; a 128-row Q chunk, then a 64-key K chunk; or a V tile
// of kNp panels), a key-bias vector a slot (written with a tile's last
// score item), and the mbarriers (Q, full[s], empty[s]).
template <int kAcc> struct PanelLayout {
  static constexpr int kNp = kAcc / kPanel;
  static constexpr uint32_t kSlot = kNp * kPanelKeys * 128;
  static constexpr uint32_t kQ = kNp * kWgRows * 128;
  static constexpr uint32_t kQChunk = kWgRows * 128;  // a streamed Q chunk; its K chunk follows
  __host__ __device__ static constexpr uint32_t ring(bool resident) { return resident ? kQ : 0; }
  __host__ __device__ static constexpr uint32_t bias(bool resident) { return ring(resident) + kPanelStages * kSlot; }
  __host__ __device__ static constexpr uint32_t bars(bool resident) {
    return bias(resident) + kPanelStages * kPanelKeys * 4;
  }
  __host__ __device__ static constexpr size_t smem(bool resident) {
    return bars(resident) + 8 * (1 + 2 * kPanelStages) + 1024;
  }
  static_assert(kQChunk + kPanelKeys * 128 <= kSlot, "a Q and a K chunk fit a slot");
  static_assert(kSlot % 1024 == 0 && kQ % 1024 == 0, "swizzle atoms are 1024-byte aligned");
};
static_assert(PanelLayout<256>::smem(true) <= 232448, "a block's shared memory");

// K1's second pass over a tile's N scores in sc (mma.sync's layout): p =
// 2^(s * scale + bias - mu) * inv, with the rows' max mu and 1 / sum from
// the first pass.
template <int N>
__device__ __forceinline__ void normalized_p(float (&sc)[N / 2], const float* bias, float scale,
                                             const float (&mu)[2], const float (&inv)[2]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale, e % 2 ? bb.y : bb.x) - mu[e / 2]) * inv[e / 2];
  }
}

// Write a warp's 16 rows (from row0) of a 64 x N accumulator times f[r]
// into columns [col0, col0 + min(N, ncols)) of bf16 rows of D values; rows
// at or past L are skipped.
template <int N>
__device__ __forceinline__ void store_acc_cols(const float (&a)[N / 2], const float (&f)[2], bf16* x_bh, int D,
                                               int row0, int L, int col0, int ncols) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= L) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(x_bh + (size_t)row * D + col0);
#pragma unroll
    for (int dn = 0; dn < N / 8; ++dn)
      if (8 * dn < ncols) dst[4 * dn + t] = pack_bf16(a[4 * dn + 2 * r] * f[r], a[4 * dn + 2 * r + 1] * f[r]);
  }
}

// K1 (kTwoPass) and K2 in bf16 above head dim 128. Grid (ceil(Lq / 128),
// B*H, panels), 256 threads, PanelLayout<kAcc>::smem(D == kAcc) bytes.
template <int kAcc, bool kTwoPass>
__global__ void __launch_bounds__(kWgConsumerThreads, 1)
attention_panels_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                       bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk, int D, int P,
                       float scale_log2) {
  using L = PanelLayout<kAcc>;
  constexpr int kNp = L::kNp, S = kPanelStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  const bool resident = D == kAcc;  // one panel: Q stays
  const uint32_t s_q = sm.base, ring = sm.base + L::ring(resident), bar_q = sm.base + L::bars(resident);
  float* bias0 = reinterpret_cast<float*>(sm.ptr + L::bias(resident));
  auto slot = [&](int s) { return ring + s * L::kSlot; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + S + s); };

  const int q0 = blockIdx.x * kWgRows, bh = blockIdx.y, c0 = blockIdx.z * P, tid = threadIdx.x;
  const int ncols = min(P, D - c0);
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kPanelKeys - 1) / kPanelKeys, nqk = resident ? 1 : D / kPanel;
  const int total = panel_items(tiles, nqk, kTwoPass);
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // warp 0's lanes, each after its bias values
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the init

  // Warp 0's producer work for item i: wait until item i - S has been
  // consumed, write the tile's key bias with its last score item, then
  // start the item's loads (lane 0; the other lanes arrive on full once
  // their bias values are written). V boxes that start past D are not
  // loaded: their columns are past the block's panel.
  auto load = [&](int i) {
    const int s = i % S, lane = tid;
    if (i >= S) mbar_wait(empty(s), (i / S - 1) & 1);
    const PanelItem it = panel_item(i, tiles, nqk, kTwoPass);
    const int k0 = it.t * kPanelKeys;
    if (it.c == nqk - 1)
      for (int j = lane; j < kPanelKeys; j += 32) bias0[s * kPanelKeys + j] = key_bias(mask_b, k0 + j, Lk, all_masked);
    if (lane == 0) {
      if (it.c == nqk) {
        const int boxes = min(kNp, (D - c0 + kPanel - 1) / kPanel);
        mbar_expect_tx(full(s), boxes * kPanelKeys * 128);
        for (int h = 0; h < boxes; ++h) tma_load(slot(s) + h * kPanelKeys * 128, &tv, c0 + h * kPanel, k0, bh, full(s));
      } else if (resident) {
        mbar_expect_tx(full(s), L::kSlot);
#pragma unroll
        for (int h = 0; h < kNp; ++h) tma_load(slot(s) + h * kPanelKeys * 128, &tk, h * kPanel, k0, bh, full(s));
      } else {
        mbar_expect_tx(full(s), L::kQChunk + kPanelKeys * 128);
        tma_load(slot(s), &tq, it.c * kPanel, q0, bh, full(s));
        tma_load(slot(s) + L::kQChunk, &tk, it.c * kPanel, k0, bh, full(s));
      }
    } else {
      mbar_arrive(full(s));
    }
  };
  if (tid < 32) {  // warp 0: Q, then the ring's first items
    if (resident && tid == 0) {
      mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int h = 0; h < kNp; ++h) tma_load(s_q + h * kWgRows * 128, &tq, h * kPanel, q0, bh, bar_q);
    }
    for (int i = 0; i < min(total, S); ++i) load(i);
    __syncwarp();
  }

  const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
  const float scale = all_masked ? 0.f : scale_log2;
  int i = 0;  // the item the block consumes next
  auto release = [&] {  // the block has consumed item i
    mbar_arrive(empty(i % S));
    if (tid < 32 && i + S < total) {
      load(i + S);
      __syncwarp();
    }
    ++i;
  };
  // The scores of the next tile into sc; returns its key bias, in the slot
  // of its last score item, which the caller releases once it has read it.
  auto scores = [&](float (&sc)[kPanelKeys / 2]) -> const float* {
    for (int c = 0; c < nqk; ++c) {
      const int s = i % S;
      mbar_wait(full(s), (i / S) & 1);
      wgmma_fence();
      if (resident) {
#pragma unroll
        for (int kk = 0; kk < kNp * 4; ++kk)
          Gmma<kPanelKeys>::template ss<0>(sc, desc_k<kWgRows>(s_q, 64 * wc, kk),
                                           desc_k<kPanelKeys>(slot(s), 0, kk), kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Gmma<kPanelKeys>::template ss<0>(sc, desc_k<kWgRows>(slot(s), 64 * wc, kk),
                                           desc_k<kPanelKeys>(slot(s) + L::kQChunk, 0, kk), c + kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (c + 1 < nqk) release();
    }
    return bias0 + (i % S) * kPanelKeys;
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2], mu[2], inv[2];
  if (resident) mbar_wait(bar_q, 0);
  if constexpr (kTwoPass) {  // pass 1: each row's max and normaliser
    for (int t = 0; t < tiles; ++t) {
      float sc[kPanelKeys / 2];
      const float* bias = scores(sc);
      flash_softmax<kPanelKeys>(sc, bias, scale, m, l, alpha);
      release();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
      mu[r] = m[r] == -INFINITY ? 0.f : m[r];
    }
  }
  float o[kNp][kPanel / 2];
#pragma unroll
  for (int h = 0; h < kNp; ++h)
#pragma unroll
    for (int e = 0; e < kPanel / 2; ++e) o[h][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    float sc[kPanelKeys / 2];
    const float* bias = scores(sc);
    if constexpr (kTwoPass) {
      normalized_p<kPanelKeys>(sc, bias, scale, mu, inv);
    } else {
      flash_softmax<kPanelKeys>(sc, bias, scale, m, l, alpha);
#pragma unroll
      for (int h = 0; h < kNp; ++h)
#pragma unroll
        for (int e = 0; e < kPanel / 2; ++e) o[h][e] *= alpha[(e / 2) % 2];
    }
    release();  // the tile's last score item: its bias has been read
    uint32_t pa[kPanelKeys / 16][4];
    pack_a<kPanelKeys>(sc, pa);
    const int s = i % S;
    mbar_wait(full(s), (i / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kNp; ++h)
#pragma unroll
      for (int kk = 0; kk < kPanelKeys / 16; ++kk)
        Gmma<kPanel>::template rs<1>(o[h], pa[kk], desc_mn<kPanelKeys>(slot(s) + h * kPanelKeys * 128, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kNp; ++h) fence_regs(o[h]);
    release();
  }
  if constexpr (!kTwoPass) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
  }
  const int row0 = q0 + 64 * wc + 16 * w;
  const float f[2] = {kTwoPass ? 1.f : inv[0], kTwoPass ? 1.f : inv[1]};
#pragma unroll
  for (int h = 0; h < kNp; ++h)
    store_acc_cols<kPanel>(o[h], f, out + (size_t)bh * Lq * D, D, row0, Lq, c0 + h * kPanel, ncols - h * kPanel);
  if (lse != nullptr && blockIdx.z == 0 && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < Lq) lse[(size_t)bh * Lq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ----------------------------- B.4's pair in bf16 above head dim 256, wgmma
// The backward section's contract (FlashAttention-2's pair: the dQ kernel
// writes each row's lse2 and D to the scratch of scratch_rows, 128-row
// blocks here, then the dK/dV kernel runs; no atomics; S the forward's to
// the bit, scale_log2 as K2 computes it) at every multiple of 64 above 256,
// on the Hopper bodies' scheme: two consumer warpgroups of 64 rows (256
// threads, 255 registers a thread), warp 0 the producer in line as in
// attention_panels_wgmma (it starts item i + 4 once the block has consumed
// item i), TMA items (the 128-byte swizzle) into a ring of four slots, wgmma
// from shared memory for the score products, their accumulators rounded to
// bf16 and repacked in registers as the A operand of the next product. A Q
// or dO tile over the whole head does not fit beside a ring above 256 (128
// rows of 320 bf16 are 80 KB), so the score operands stream in 64-column
// chunks and shared memory does not grow with D:
//  * dQ: grid (Lq_pad / 128, B*H, panels) on the forward's column panels
//    (panel_plan: 320 -> 2 x 160, 384 -> 2 x 192, kAcc = 192 or 256
//    accumulated columns). For each key tile (64 keys; 32 at kAcc 256,
//    whose 128 accumulators a thread leave no room for 64-key S and dP
//    tiles) the block sums S = Q K^T and dP = dO V^T over D / 64 items of
//    four chunks (Q and dO: the block's 128 rows; K and V: the tile's keys),
//    forms dS = P * (dP - D) in registers, then adds dS K into its panel's
//    columns from one more item (K's columns of the panel, V's place in
//    the forward's stream). A dQ row of 320 columns does not fit beside S
//    and dP in 255 registers, so each z block recomputes S and dP over all
//    of D (at D 320: 2 x 2 x 320 columns of score products a query-key pair
//    for 2 x 160 of dS K, where one block would do 640 + 320).
//  * dK/dV: grid (ceil(Lk / 128), B*H, ceil(D / 128)). A block owns 128
//    keys (64 a warpgroup) and 128 columns of dK and of dV (two 64-column
//    accumulators each, 128 floats a thread), and walks the query rows in
//    64-row tiles: S^T = K Q^T and dP^T = V dO^T over D / 64 items of four
//    chunks (K and V: the block's 128 keys; Q and dO: the tile's rows; the
//    last also brings the tile's lse2 and D by bulk copy), then dV += P^T dO
//    and dK += dS^T Q from one item of dO's and Q's columns. 128 columns
//    are the widest split the registers hold: with the S^T and dP^T tiles
//    (64 floats) a thread holds 192 floats; 192 columns (three panels)
//    would be 256, and 160 would take a product over half a swizzle panel.
//    Every column block recomputes S^T and dP^T over all of D (at D 320:
//    3 blocks, 3 x 2 x 320 + 2 x 320 columns of products a query-key pair
//    against 4 x 320 with no split, 2.0x).
//  * Bound: operations, on the tensor cores: 10 flops a query-key-dim over
//    the valid keys at 989 TFLOP/s; at (1, 4, 1008, 1008, 320) 0.0132 ms.
//    The grids are small there (dQ 8 row blocks x 4 heads x 2 panels, dK/dV
//    8 x 4 x 3 column blocks: 64 and 96 blocks for 132 SMs, one block an
//    SM), so the batch-8 shape is the one that fills the card.
template <int kAcc> struct PairDqLayout {
  static constexpr int kKeys = kAcc == 256 ? 32 : 64;     // keys a tile
  static constexpr int kNp = kAcc / kPanel;               // 64-column panels accumulated
  static constexpr uint32_t kChunk = kWgRows * 128;       // 128 rows x 64 columns of Q or dO
  static constexpr uint32_t kKChunk = kKeys * 128;        // a tile's 64 columns of K or V
  static constexpr uint32_t kSlot = 2 * kChunk + 2 * kKChunk;
  static constexpr uint32_t kBias = kPanelStages * kSlot;  // a key-bias vector a slot
  static constexpr uint32_t kBars = kBias + kPanelStages * kKeys * 4;
  static constexpr size_t kSmem = kBars + 8 * 2 * kPanelStages + 1024;
  static_assert(kNp * kKChunk <= kSlot, "K's columns of a panel fit a slot");
  static_assert(kSlot % 1024 == 0 && kKChunk % 1024 == 0, "swizzle atoms are 1024-byte aligned");
  static_assert(kSmem <= 232448, "a block's shared memory");
};
struct PairDkdvLayout {
  static constexpr int kCols = 2 * kPanel;                // dK and dV columns a block
  static constexpr int kRowsQ = 64;                       // query rows a tile
  static constexpr uint32_t kKV = kWgRows * 128;          // 128 keys x 64 columns of K or V
  static constexpr uint32_t kQ = kRowsQ * 128;            // a tile's 64 columns of Q or dO
  static constexpr uint32_t kSlot = 2 * kKV + 2 * kQ;     // four score chunks; an output item is 4 x kQ
  static constexpr uint32_t kVec = kPanelStages * kSlot;  // a tile's lse2 and D, a slot
  static constexpr uint32_t kBars = kVec + kPanelStages * 2 * kRowsQ * 4;
  static constexpr size_t kSmem = kBars + 8 * 2 * kPanelStages + 1024;
  static_assert(kSlot % 1024 == 0 && kQ % 1024 == 0, "swizzle atoms are 1024-byte aligned");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// B.4's dQ in bf16 above head dim 256. Grid (Lq_pad / 128, B*H, panels),
// 256 threads, PairDqLayout<kAcc>::kSmem bytes. Its z = 0 blocks write each
// row's lse2 (base 2; +inf past Lq, so that those rows get P = 0) and D =
// rowsum(dO * out) to the scratch for the dK/dV kernel.
template <int kAcc>
__global__ void __launch_bounds__(kWgConsumerThreads, 1)
attention_bwd_dq_wgmma_panels(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                              const uint8_t* __restrict__ mask, const bf16* __restrict__ out,
                              const float* __restrict__ lse, const bf16* __restrict__ g, bf16* __restrict__ dq,
                              float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq, int Lk,
                              int D, int P, int Lq_pad, float scale_log2, float scale) {
  using L = PairDqLayout<kAcc>;
  constexpr int kKeys = L::kKeys, kNp = L::kNp, S = kPanelStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  float* bias0 = reinterpret_cast<float*>(sm.ptr + L::kBias);
  auto slot = [&](int s) { return sm.base + s * L::kSlot; };
  auto full = [&](int s) { return sm.base + L::kBars + 8 * s; };
  auto empty = [&](int s) { return sm.base + L::kBars + 8 * (S + s); };

  const int q0 = blockIdx.x * kWgRows, bh = blockIdx.y, c0 = blockIdx.z * P, tid = threadIdx.x;
  const int ncols = min(P, D - c0);
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kKeys - 1) / kKeys, nqk = D / kPanel, total = tiles * (nqk + 1);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // warp 0's lanes, each after its bias values
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the init

  // Warp 0's producer work for item i (tile i / (nqk + 1); its chunks c <
  // nqk of Q, dO, K and V, then c == nqk K's columns of the block's panel):
  // wait until item i - S has been consumed, write the tile's key bias with
  // its last score item, then start the item's loads (lane 0; the other
  // lanes arrive on full once their bias values are written). K boxes that
  // start past D are not loaded: their columns are past the panel.
  auto load = [&](int i) {
    const int s = i % S, lane = tid;
    if (i >= S) mbar_wait(empty(s), (i / S - 1) & 1);
    const int t = i / (nqk + 1), c = i % (nqk + 1), k0 = t * kKeys;
    if (c == nqk - 1)
      for (int j = lane; j < kKeys; j += 32) bias0[s * kKeys + j] = key_bias(mask_b, k0 + j, Lk, all_masked);
    if (lane == 0) {
      if (c == nqk) {
        const int boxes = min(kNp, (D - c0 + kPanel - 1) / kPanel);
        mbar_expect_tx(full(s), boxes * L::kKChunk);
        for (int h = 0; h < boxes; ++h) tma_load(slot(s) + h * L::kKChunk, &tk, c0 + h * kPanel, k0, bh, full(s));
      } else {
        mbar_expect_tx(full(s), L::kSlot);
        tma_load(slot(s), &tq, c * kPanel, q0, bh, full(s));
        tma_load(slot(s) + L::kChunk, &tg, c * kPanel, q0, bh, full(s));
        tma_load(slot(s) + 2 * L::kChunk, &tk, c * kPanel, k0, bh, full(s));
        tma_load(slot(s) + 2 * L::kChunk + L::kKChunk, &tv, c * kPanel, k0, bh, full(s));
      }
    } else {
      mbar_arrive(full(s));
    }
  };
  if (tid < 32) {  // warp 0: the ring's first items
    for (int i = 0; i < min(total, S); ++i) load(i);
    __syncwarp();
  }

  const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
  const float scale_p = all_masked ? 0.f : scale_log2;
  const int row0 = q0 + 64 * wc + 16 * w;
  const size_t q_off = (size_t)bh * Lq * D;
  // D and lse in base 2 of the warp's rows lane / 4 and + 8 (D over the whole
  // head, the quad's four threads every fourth pair of columns, in the
  // order attention_bwd_dq_wgmma sums them), into registers and the scratch.
  float dsum[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    float part = 0.f;
    if (row < Lq) {
      const uint32_t* gr = reinterpret_cast<const uint32_t*>(g + q_off + (size_t)row * D);
      const uint32_t* orow = reinterpret_cast<const uint32_t*>(out + q_off + (size_t)row * D);
      for (int c = t4; c < D / 2; c += 4) {
        const float2 a = unpack_bf16(gr[c]), b = unpack_bf16(orow[c]);
        part = fmaf(a.y, b.y, fmaf(a.x, b.x, part));
      }
    }
    dsum[r] = quad_sum(part);
    lse2[r] = row < Lq ? lse[(size_t)bh * Lq + row] * kLog2e : INFINITY;
    if (blockIdx.z == 0 && t4 == 0) {
      lse2_pad[(size_t)bh * Lq_pad + row] = lse2[r];
      dsum_pad[(size_t)bh * Lq_pad + row] = dsum[r];
    }
  }

  int i = 0;  // the item the block consumes next
  auto release = [&] {  // the block has consumed item i
    mbar_arrive(empty(i % S));
    if (tid < 32 && i + S < total) {
      load(i + S);
      __syncwarp();
    }
    ++i;
  };
  float acc[kNp][kPanel / 2];
#pragma unroll
  for (int h = 0; h < kNp; ++h)
#pragma unroll
    for (int e = 0; e < kPanel / 2; ++e) acc[h][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    float sc[kKeys / 2], dp[kKeys / 2];
    for (int c = 0; c < nqk; ++c) {
      const int s = i % S;
      mbar_wait(full(s), (i / S) & 1);
      const uint32_t sq = slot(s), sg = sq + L::kChunk, sk = sg + L::kChunk, sv = sk + L::kKChunk;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Gmma<kKeys>::template ss<0>(sc, desc_k<kWgRows>(sq, 64 * wc, kk), desc_k<kKeys>(sk, 0, kk), c + kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Gmma<kKeys>::template ss<0>(dp, desc_k<kWgRows>(sg, 64 * wc, kk), desc_k<kKeys>(sv, 0, kk), c + kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (c + 1 < nqk) release();
    }
    const float* b = bias0 + (i % S) * kKeys;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * n + e;
        sc[j] = ex2(fmaf(sc[j], scale_p, e % 2 ? bb.y : bb.x) - lse2[e / 2]) * (dp[j] - dsum[e / 2]);
      }
    }
    release();  // the tile's last score item: its bias has been read
    uint32_t da[kKeys / 16][4];
    pack_a<kKeys>(sc, da);
    const int s = i % S;
    mbar_wait(full(s), (i / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kNp; ++h)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        Gmma<kPanel>::template rs<1>(acc[h], da[kk], desc_mn<kKeys>(slot(s) + h * L::kKChunk, kk));
    wgmma_commit();  // dQ += dS K
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kNp; ++h) fence_regs(acc[h]);
    release();
  }
  const float sc2[2] = {scale, scale};
#pragma unroll
  for (int h = 0; h < kNp; ++h)
    store_acc_cols<kPanel>(acc[h], sc2, dq + q_off, D, row0, Lq, c0 + h * kPanel, ncols - h * kPanel);
}

// B.4's dK/dV in bf16 above head dim 256. Grid (ceil(Lk / 128), B*H,
// ceil(D / 128)), 256 threads, PairDkdvLayout::kSmem bytes.
__global__ void __launch_bounds__(kWgConsumerThreads, 1)
attention_bwd_dkdv_wgmma_panels(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                                const uint8_t* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv,
                                const float* __restrict__ lse2_pad, const float* __restrict__ dsum_pad, int H,
                                int Lq, int Lk, int D, int Lq_pad, float scale_log2, float scale) {
  using L = PairDkdvLayout;
  constexpr int S = kPanelStages, kR = L::kRowsQ;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WgSmem sm(smem_raw);
  auto slot = [&](int s) { return sm.base + s * L::kSlot; };
  auto vec = [&](int s) { return sm.base + L::kVec + s * 2 * kR * 4; };  // lse2, then D
  auto full = [&](int s) { return sm.base + L::kBars + 8 * s; };
  auto empty = [&](int s) { return sm.base + L::kBars + 8 * (S + s); };

  const int k0 = blockIdx.x * kWgRows, bh = blockIdx.y, c0 = blockIdx.z * L::kCols, tid = threadIdx.x;
  const int ncols = min(L::kCols, D - c0), boxes = min(2, (ncols + kPanel - 1) / kPanel);
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = Lq_pad / kR, nqk = D / kPanel, total = tiles * (nqk + 1);
  const size_t pad_off = (size_t)bh * Lq_pad;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumerThreads);
    }
    mbar_init_fence();
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);

  // Thread 0's producer work for item i (query tile i / (nqk + 1); its
  // chunks c < nqk of K, V, Q and dO, the last with the tile's lse2 and D,
  // then c == nqk the tile's dO and Q over the block's columns).
  auto load = [&](int i) {
    const int s = i % S;
    if (i >= S) mbar_wait(empty(s), (i / S - 1) & 1);
    const int t = i / (nqk + 1), c = i % (nqk + 1), r0 = t * kR;
    if (c == nqk) {
      mbar_expect_tx(full(s), 2 * boxes * L::kQ);
      for (int h = 0; h < boxes; ++h) {
        tma_load(slot(s) + h * L::kQ, &tg, c0 + h * kPanel, r0, bh, full(s));
        tma_load(slot(s) + (2 + h) * L::kQ, &tq, c0 + h * kPanel, r0, bh, full(s));
      }
    } else {
      const bool last = c == nqk - 1;
      mbar_expect_tx(full(s), L::kSlot + (last ? 2 * kR * 4 : 0));
      tma_load(slot(s), &tk, c * kPanel, k0, bh, full(s));
      tma_load(slot(s) + L::kKV, &tv, c * kPanel, k0, bh, full(s));
      tma_load(slot(s) + 2 * L::kKV, &tq, c * kPanel, r0, bh, full(s));
      tma_load(slot(s) + 2 * L::kKV + L::kQ, &tg, c * kPanel, r0, bh, full(s));
      if (last) {
        bulk_load(vec(s), lse2_pad + pad_off + r0, kR * 4, full(s));
        bulk_load(vec(s) + kR * 4, dsum_pad + pad_off + r0, kR * 4, full(s));
      }
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(total, S); ++i) load(i);
  __syncwarp();

  const int wc = tid / kWgThreads, w = (tid / 32) % 4, lane = tid % 32, t4 = lane % 4;
  const float scale_p = all_masked ? 0.f : scale_log2;
  const int key0 = k0 + 64 * wc + 16 * w;
  const float kbias[2] = {key_bias(mask_b, key0 + lane / 4, Lk, all_masked),
                          key_bias(mask_b, key0 + lane / 4 + 8, Lk, all_masked)};
  int i = 0;
  auto release = [&] {
    mbar_arrive(empty(i % S));
    if (tid < 32) {
      if (tid == 0 && i + S < total) load(i + S);
      __syncwarp();
    }
    ++i;
  };
  float dka[2][kPanel / 2], dva[2][kPanel / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < kPanel / 2; ++e) dka[h][e] = dva[h][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    float p[kR / 2], ds[kR / 2];
    for (int c = 0; c < nqk; ++c) {
      const int s = i % S;
      mbar_wait(full(s), (i / S) & 1);
      const uint32_t sk = slot(s), sv = sk + L::kKV, sq = sv + L::kKV, sg = sq + L::kQ;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S^T (unscaled): this warpgroup's keys x the tile's queries
        Gmma<kR>::template ss<0>(p, desc_k<kWgRows>(sk, 64 * wc, kk), desc_k<kR>(sq, 0, kk), c + kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP^T = V dO^T
        Gmma<kR>::template ss<0>(ds, desc_k<kWgRows>(sv, 64 * wc, kk), desc_k<kR>(sg, 0, kk), c + kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p);
      fence_regs(ds);
      if (c + 1 < nqk) release();
    }
    const float* l2 = reinterpret_cast<const float*>(sm.ptr + (vec(i % S) - sm.base));
    const float* dd = l2 + kR;
#pragma unroll
    for (int n = 0; n < kR / 8; ++n) {
      const float2 l2p = *reinterpret_cast<const float2*>(l2 + 8 * n + 2 * t4);
      const float2 ddp = *reinterpret_cast<const float2*>(dd + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e % 2: query 8n + 2 t4 + e % 2; e / 2: key row lane / 4 or + 8
        const int j = 4 * n + e;
        p[j] = ex2(fmaf(p[j], scale_p, kbias[e / 2]) - (e % 2 ? l2p.y : l2p.x));
        ds[j] = p[j] * (ds[j] - (e % 2 ? ddp.y : ddp.x));
      }
    }
    release();  // the tile's last score item: its lse2 and D have been read
    uint32_t pa[kR / 16][4], da[kR / 16][4];
    pack_a<kR>(p, pa);
    pack_a<kR>(ds, da);
    const int s = i % S;
    mbar_wait(full(s), (i / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a panel past D (boxes 1) reads what its slot held: its columns are not stored
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk)
        Gmma<kPanel>::template rs<1>(dva[h], pa[kk], desc_mn<kR>(slot(s) + h * L::kQ, kk));
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk)
        Gmma<kPanel>::template rs<1>(dka[h], da[kk], desc_mn<kR>(slot(s) + (2 + h) * L::kQ, kk));
    }
    wgmma_commit();  // dV += P^T dO, dK += dS^T Q
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fence_regs(dva[h]);
      fence_regs(dka[h]);
    }
    release();
  }
  const size_t kv_off = (size_t)bh * Lk * D;
  const float sc[2] = {scale, scale}, one[2] = {1.f, 1.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    store_acc_cols<kPanel>(dka[h], sc, dk + kv_off, D, key0, Lk, c0 + h * kPanel, ncols - h * kPanel);
    store_acc_cols<kPanel>(dva[h], one, dv + kv_off, D, key0, Lk, c0 + h * kPanel, ncols - h * kPanel);
  }
}

// ------------------------------------------------- float32, CUDA cores
// float32 K1 at head dims 64 and 128 (33-128 padded to them) runs this body
// too, instantiated at 64 and 128 accumulated columns: one panel, the whole
// head. It was chosen over a body of its own because the scheme is the one
// those head dims lacked (register tiles, float4 operands at compile-time
// strides, cp.async items, shared memory independent of Lk), and one body
// keeps one set of edges to test. What the small head dims add is
// occupancy: the launch bounds ask for three blocks an SM at 64 (at most 80
// registers a thread) and two at 128 (at most 128), so that another
// block's warps run while one waits at a barrier or on a copy, and the
// shared memory a block takes is held under an SM's share for that many
// (panel_f32_min_blocks). At 128 that streams Q (see panel_f32_resident).
// K1 walks its first pass from the last key tile to the first and keeps
// tile 0's scores in registers for the second pass, which starts there:
// one tile's Q.K^T fewer, and with one key tile (CLIP's 50 keys) a single
// Q.K^T, as the exact two-pass softmax needs. A thread whose rows are all
// past the block's last query row skips the products (the last row block
// of 197 tokens holds 5 rows).
constexpr int kPanelLdP = kPanelKeys + 4;  // row stride of a tile's p (floats)
constexpr int kPanelLdC = kPanel + 4;      // of a streamed 64-column chunk of Q or K
constexpr int kSmBytes = 233472;           // an SM's shared memory; a block also reserves 1 KB

// The blocks an SM that attention_panels_fma<kAcc, *> is built for (its
// launch bounds' minimum): three at 64 accumulated columns, two at 128, one
// above.
__host__ __device__ constexpr int panel_f32_min_blocks(int acc) { return acc == 64 ? 3 : acc == 128 ? 2 : 1; }
// Whether a block keeps Q in shared memory: with one panel (D <= acc), but
// not at 128 columns, where Q (64 rows of 132 floats) beside the two slots
// and p would take 118,784 B, over the 115,712 B a block may take when two
// share an SM. Q streams there in 64-column chunks beside K's, as above 256.
__host__ __device__ constexpr bool panel_f32_resident(int D, int acc) { return D <= acc && acc != 128; }
// Floats of a ring slot: 64 rows of acc + 4 (a K tile over all of D when Q
// stays, which is then acc; a V tile of acc columns), or a Q chunk and a K
// chunk of 64 + 4 each when Q streams, whichever is larger.
__host__ __device__ constexpr int panel_f32_slot(int acc, bool resident) {
  return kRows * (resident || acc + 4 >= 2 * kPanelLdC ? acc + 4 : 2 * kPanelLdC);
}
// Shared memory in bytes: Q when it stays (64 rows of D + 4), two ring
// slots and the tile's p (64 x 68). Rows are padded by 4 floats so that
// the 16 threads that read 16 rows as float4s meet every bank in two
// wavefronts.
__host__ __device__ constexpr size_t panel_f32_smem_bytes(int D, int acc) {
  return ((panel_f32_resident(D, acc) ? (size_t)kRows * (D + 4) : 0) +
          2 * (size_t)panel_f32_slot(acc, panel_f32_resident(D, acc)) + kRows * kPanelLdP) *
         sizeof(float);
}
static_assert(panel_f32_smem_bytes(256, 256) <= 232448, "a block's shared memory");
static_assert(3 * (panel_f32_smem_bytes(64, 64) + 1024) <= kSmBytes, "three K1 blocks an SM at 64");
static_assert(2 * (panel_f32_smem_bytes(128, 128) + 1024) <= kSmBytes, "two K1 blocks an SM at 128");

// Rows [0, n) of a float array with rows of ld_src from column 0 on, kCols
// columns, into shared rows of ld_dst floats, a 16-byte cp.async each;
// zero from row n and column w on.
template <int kCols>
__device__ __forceinline__ void stage_panel(float* dst, int ld_dst, const float* src, size_t ld_src, int n, int w) {
  constexpr int kC4 = kCols / 4;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kRows * kC4; idx += kThreads) {
    const int r = idx / kC4, c = idx % kC4 * 4;
    const bool ok = r < n && c < w;
    cp_async16(smem_u32(dst + r * ld_dst + c), ok ? src + r * ld_src + c : src, ok);
  }
}

// s[i][j] += a[ty + 16 i] . b[tx + 16 j] over DEPTH columns (rows of LD
// floats, both compile-time, so that every shared load takes an immediate
// offset), for key groups j < NJ: per step of 4 columns 4 + NJ float4 reads
// and 16 NJ FMAs. kLean (the bodies under a register cap of 80 or 128:
// three or two blocks an SM) reads one key group's float4 at a time and does
// not unroll the steps, so that 5 float4 operands are live, not 4 x 8.
template <int NJ, int LD, int DEPTH, bool kLean>
__device__ __forceinline__ void panel_dots(float (&s)[4][4], const float* a, const float* b) {
  a += (threadIdx.x / 16) * LD;
  b += (threadIdx.x % 16) * LD;
  if constexpr (kLean) {
#pragma unroll 1
    for (int d = 0; d < DEPTH; d += 4) {
      float4 x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = *reinterpret_cast<const float4*>(a + 16 * r * LD + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(b + 16 * j * LD + d);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[r][j] = fmaf(x[r].w, y.w, fmaf(x[r].z, y.z, fmaf(x[r].y, y.y, fmaf(x[r].x, y.x, s[r][j]))));
      }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < DEPTH; d += 4) {
      float4 x[4], y[NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = *reinterpret_cast<const float4*>(a + 16 * r * LD + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = *reinterpret_cast<const float4*>(b + 16 * j * LD + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          s[r][j] = fmaf(x[r].w, y[j].w, fmaf(x[r].z, y[j].z, fmaf(x[r].y, y[j].y, fmaf(x[r].x, y[j].x, s[r][j]))));
    }
  }
}
// The same over a tile of nk keys: the groups of 16 keys that hold one.
template <int LD, int DEPTH, bool kLean = false>
__device__ __forceinline__ void panel_dots(float (&s)[4][4], const float* a, const float* b, int nk) {
  if (nk > 48) panel_dots<4, LD, DEPTH, kLean>(s, a, b);
  else if (nk > 32) panel_dots<3, LD, DEPTH, kLean>(s, a, b);
  else if (nk > 16) panel_dots<2, LD, DEPTH, kLean>(s, a, b);
  else panel_dots<1, LD, DEPTH, kLean>(s, a, b);
}

// o[i][c] += sum_j p[ty + 16 i][j] * v[j][4 tx + 64 c .. + 3] over the
// keys j < nk (rounded up to 4; p is 0 past nk and v's rows are zero past
// Lk): per 4 keys 4 + 4 kC4 float4 reads and 64 kC4 FMAs.
template <int kC4>
__device__ __forceinline__ void panel_pv(float4 (&o)[4][kC4], const float* sp, const float* sv, int ldv, int nk) {
  sp += (threadIdx.x / 16) * kPanelLdP;
  sv += 4 * (threadIdx.x % 16);
  for (int j = 0; j < nk; j += 4) {
    float4 p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = *reinterpret_cast<const float4*>(sp + 16 * r * kPanelLdP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 y[kC4];
#pragma unroll
      for (int c = 0; c < kC4; ++c) y[c] = *reinterpret_cast<const float4*>(sv + (j + jj) * ldv + 64 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
#pragma unroll
        for (int c = 0; c < kC4; ++c) {
          o[r][c].x = fmaf(pr, y[c].x, o[r][c].x);
          o[r][c].y = fmaf(pr, y[c].y, o[r][c].y);
          o[r][c].z = fmaf(pr, y[c].z, o[r][c].z);
          o[r][c].w = fmaf(pr, y[c].w, o[r][c].w);
        }
      }
    }
  }
}

// Max and sum over the 16 lanes of a half warp (the threads of a row).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Item i of the float32 body's stream (panel_item's, with K1's first pass
// over the tiles from the last to the first, and its second pass taking
// tile 0's V alone: tile 0's scores are still in registers).
__device__ __forceinline__ PanelItem fma_item(int i, int tiles, int nqk, bool two_pass) {
  if (!two_pass) return {i / (nqk + 1), i % (nqk + 1)};
  if (i < tiles * nqk) return {tiles - 1 - i / nqk, i % nqk};
  i -= tiles * nqk;
  if (i == 0) return {0, nqk};
  --i;
  return {1 + i / (nqk + 1), i % (nqk + 1)};
}
__device__ __forceinline__ int fma_items(int tiles, int nqk, bool two_pass) {
  return two_pass ? tiles * nqk + 1 + (tiles - 1) * (nqk + 1) : tiles * (nqk + 1);
}

// K1 (kTwoPass) and K2 in float32: above head dim 128, and K1 at 64 and
// 128. Grid (ceil(Lq / 64), B*H, panels), at 64 and 128 (B*H, ceil(Lq /
// 64)), kThreads threads, panel_f32_smem_bytes(D, kAcc) bytes.
template <int kAcc, bool kTwoPass>
__global__ void __launch_bounds__(kThreads, panel_f32_min_blocks(kAcc))
attention_panels_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int H,
                     int Lq, int Lk, int D, int P, float scale_log2) {
  constexpr int kC4 = kAcc / 64;  // float4 output columns a thread
  constexpr int kLdV = kAcc + 4;
  // Under the register caps of three or two blocks an SM: panel_dots's lean
  // form, and K1's row max and 1 / sum kept after pass 1 in the padding
  // columns 64 and 65 of p's rows (no read of p reaches them; the 16 threads
  // of a row write the same values) instead of 8 registers a thread.
  constexpr bool kLean = kAcc <= 128;
  extern __shared__ __align__(16) float fsm[];
  const bool resident = panel_f32_resident(D, kAcc);  // Q stays
  const int ldq = D + 4, slot = panel_f32_slot(kAcc, resident);
  float* sq = fsm;
  float* ring = fsm + (resident ? kRows * ldq : 0);
  float* sp = ring + 2 * slot;

  // K1 at 64 and 128 walks the grid head first (x), so that every head's
  // last, short row block comes at the end of the grid, where it fills the
  // tail; the other bodies keep a head's row blocks side by side.
  constexpr bool kHeadsFirst = kAcc <= 128;
  const int q0 = (kHeadsFirst ? blockIdx.y : blockIdx.x) * kRows, bh = kHeadsFirst ? blockIdx.x : blockIdx.y;
  const int c0 = blockIdx.z * P, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nq = min(kRows, Lq - q0), ncols = min(P, D - c0);
  const bool rows_live = ty < nq;  // the thread's first row, and so some of its rows, are query rows
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kPanelKeys - 1) / kPanelKeys, nqk = resident ? 1 : D / kPanel;
  const int total = fma_items(tiles, nqk, kTwoPass);
  const float* qb = q + ((size_t)bh * Lq + q0) * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

  auto issue = [&](int i) {  // item i's copies into slot i % 2
    float* dst = ring + (i % 2) * slot;
    const PanelItem it = fma_item(i, tiles, nqk, kTwoPass);
    const int k0 = it.t * kPanelKeys, nk = min(kPanelKeys, Lk - k0);
    if (it.c == nqk) {
      stage_panel<kAcc>(dst, kLdV, vb + (size_t)k0 * D + c0, D, nk, D - c0);
    } else if (resident) {
      stage_panel<kAcc>(dst, ldq, kb + (size_t)k0 * D, D, nk, D);
    } else {
      stage_panel<kPanel>(dst, kPanelLdC, qb + it.c * kPanel, D, nq, kPanel);
      stage_panel<kPanel>(dst + kRows * kPanelLdC, kPanelLdC, kb + (size_t)k0 * D + it.c * kPanel, D, nk, kPanel);
    }
  };
  if (resident) stage_panel<kAcc>(sq, ldq, qb, D, nq, D);
  issue(0);
  cp_async_commit();
  const bool all_masked = !any_valid_key(mask_b, Lk);
  int i = 0;  // the item the block consumes next
  auto acquire = [&]() -> const float* {  // start item i + 1, wait for item i
    if (i + 1 < total) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return ring + (i % 2) * slot;
  };
  auto release = [&] {  // every thread is done with item i's slot
    __syncthreads();
    ++i;
  };
  // This thread's scaled, biased scores (log2 domain) of the tile at k0.
  auto scores = [&](int k0, float (&s)[4][4]) {
    const int nk = min(kPanelKeys, Lk - k0);
    for (int c = 0; c < nqk; ++c) {
      const float* sl = acquire();
      if (c == 0) {  // zeroed after the first item's copies are issued: no live sums while they are
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
      }
      if (rows_live) {
        if (resident) panel_dots<kAcc + 4, kAcc, kLean>(s, sq, sl, nk);  // D == kAcc
        else panel_dots<kPanelLdC, kPanel, kLean>(s, sl, sl + kRows * kPanelLdC, nk);
      }
      release();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = key < Lk && (all_masked || mask_b == nullptr || mask_b[key]);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][j] = !valid ? -INFINITY : all_masked ? 0.f : s[r][j] * scale_log2;
    }
  };

  float s[4][4];  // the scores of the current tile (K1: from pass 1's last, tile 0, into pass 2)
  float m[4], l[4], inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = -INFINITY, l[r] = 0.f, inv[r] = 1.f;
  if constexpr (kTwoPass) {  // pass 1: each row's max and normaliser, over the tiles from the last
    for (int t = tiles - 1; t >= 0; --t) {
      scores(t * kPanelKeys, s);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float m_new = fmaxf(m[r], half_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]))));
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += exp2f(s[r][j] - mu);
        l[r] = l[r] * exp2f(m[r] - mu) + sum;
        m[r] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      l[r] = half_sum(l[r]);
      inv[r] = 1.f / l[r];
      const int row = ty + 16 * r;
      if (lse != nullptr && blockIdx.z == 0 && tx == 0 && row < nq)
        lse[(size_t)bh * Lq + q0 + row] = (m[r] + log2f(l[r])) * kLn2;
      if constexpr (kLean) {
        sp[row * kPanelLdP + kPanelKeys] = m[r];
        sp[row * kPanelLdP + kPanelKeys + 1] = inv[r];
      }
    }
  }
  float4 o[4][kC4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC4; ++c) o[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kPanelKeys;
    if (!kTwoPass || t > 0) scores(k0, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (kTwoPass) {
        const float* stats = sp + (ty + 16 * r) * kPanelLdP + kPanelKeys;
        const float mr = kLean ? stats[0] : m[r], ir = kLean ? stats[1] : inv[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = exp2f(s[r][j] - mr) * ir;
      } else {
        const float m_new = fmaxf(m[r], half_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]))));
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - mu);  // 0 while m is -inf
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = exp2f(s[r][j] - mu);
          sum += s[r][j];
        }
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kC4; ++c) o[r][c] = make_float4(o[r][c].x * alpha, o[r][c].y * alpha, o[r][c].z * alpha,
                                                            o[r][c].w * alpha);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(ty + 16 * r) * kPanelLdP + tx + 16 * j] = s[r][j];
    }
    const float* sv = acquire();  // the tile's V; its barrier also publishes p
    if (rows_live) panel_pv<kC4>(o, sp, sv, kLdV, min(kPanelKeys, Lk - k0));
    release();
  }
  if constexpr (!kTwoPass) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      l[r] = half_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (row >= nq) continue;
    const float f = kTwoPass ? 1.f : inv[r];
    float* orow = out + ((size_t)bh * Lq + q0 + row) * D + c0;
#pragma unroll
    for (int c = 0; c < kC4; ++c)
      if (4 * tx + 64 * c < ncols)
        *reinterpret_cast<float4*>(orow + 4 * tx + 64 * c) =
            make_float4(o[r][c].x * f, o[r][c].y * f, o[r][c].z * f, o[r][c].w * f);
    if (!kTwoPass && lse != nullptr && blockIdx.z == 0 && tx == 0)
      lse[(size_t)bh * Lq + q0 + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// ------------------------------- B.4's pair in float32 above head dim 128
// The backward section's contract (dQ, dK, dV from the forward's
// log-sum-exp; two launches, no atomics; the dQ kernel writes lse2 and D to
// the scratch of scratch_rows, 64-row tiles) at every multiple of 64 above
// 128 (the wrapper pads 136 to 192), on the float32 forward body's scheme:
// FP32 FMAs (no TF32: the 1e-5 bar), a 16 x 16 grid of threads, each a 4 x
// 4 tile of the scores and of their gradient in registers, float4 operands
// from rows padded by 4 floats at compile-time strides (panel_dots,
// panel_pv), and items by cp.async into two ring slots. Q and dO together
// do not fit beside a ring at D 256 (2 x 64 x 260 x 4 B = 133 KB), so the
// scores' operands stream at every D in 64-column chunks: an item holds
// four 64 x 64 chunks (dQ: Q, K, dO, V; dK/dV: K, Q, V, dO), and shared
// memory does not grow with D.
//  * dQ: a block owns 64 query rows and at most 256 output columns, the
//    forward's column panels on grid z (panel_plan: 192 -> 192, 256 -> 256,
//    320 -> 2 x 160, ...). For each 64-key tile it sums S = Q K^T and dP =
//    dO V^T over the D / 64 score items, forms dS = P * (dP - D) in
//    registers and passes it through shared memory (as the forward passes
//    p), then adds dS K into a register accumulator from an item of K's
//    columns of the block's panel. Each z block recomputes S and dP over
//    all of D (at D 320: 2 x 2 x 320 columns of score products a key for
//    2 x 160 of dS K, where one block would do 640 + 320).
//  * dK/dV: a block owns 64 keys and kPairOut output columns of dK and of
//    dV, and walks the query rows in 64-row tiles: S^T = K Q^T and dP^T =
//    V dO^T in 4 x 4 register tiles, P^T and dS^T through shared memory,
//    then dV += P^T dO and dK += dS^T Q from two items of dO's and Q's
//    output columns. Grid z takes ceil(D / kPairOut) column blocks, and
//    each recomputes S^T and dP^T over all of D: at D 256 with 128 columns
//    4 D + 2 D products a query-key pair against 4 D with one block, 1.5x,
//    for twice the blocks (the D-256 VITW shapes have 8 heads x 4 key
//    blocks). 256-column blocks, the other design, were slower and
//    spilled (PERF.md).
//  * Bound: operations, on the CUDA cores: 10 flops a query-key-dim over
//    the valid keys (the forward's Q.K^T again, dP, dS K, P^T dO, dS^T Q) at
//    67 TFLOP/s; at (2, 4, 197, 197, 256) 0.0097 ms. The grids are small at
//    the VITW shapes (dQ: 4 row blocks x 8 heads), one block an SM.
constexpr int kPairOut = 128;  // dK/dV: output columns a block
constexpr int kPairChunk = kRows * kPanelLdC;  // floats of one staged 64 x 64 chunk

// Floats of a ring slot: four chunks, or 64 rows of acc + 4 (an output item).
__host__ __device__ constexpr int pair_slot(int acc) {
  return 4 * kPairChunk > kRows * (acc + 4) ? 4 * kPairChunk : kRows * (acc + 4);
}
// dQ: two slots and the tile's dS (64 x 68).
__host__ __device__ constexpr size_t pair_dq_smem_bytes(int acc) {
  return ((size_t)2 * pair_slot(acc) + kRows * kPanelLdP) * sizeof(float);
}
// dK/dV: two slots, the tile's P^T and dS^T.
__host__ __device__ constexpr size_t pair_dkdv_smem_bytes(int out) {
  return ((size_t)2 * pair_slot(out) + 2 * kRows * kPanelLdP) * sizeof(float);
}
static_assert(pair_dq_smem_bytes(256) <= 232448 && pair_dkdv_smem_bytes(256) <= 232448, "a block's shared memory");

// B.4's dQ in float32 above head dim 128. Grid (Lq_pad / 64, B*H, panels),
// kThreads threads, pair_dq_smem_bytes(kAcc) bytes. Its z = 0 blocks write
// each row's lse2 (base 2; +inf past Lq, so that those rows get P = 0) and
// D = rowsum(dO * out) to the scratch for the dK/dV kernel.
template <int kAcc>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const uint8_t* __restrict__ mask, const float* __restrict__ out,
                     const float* __restrict__ lse, const float* __restrict__ g, float* __restrict__ dq,
                     float* __restrict__ lse2_pad, float* __restrict__ dsum_pad, int H, int Lq, int Lk, int D, int P,
                     int Lq_pad, float scale_log2, float scale) {
  constexpr int kC4 = kAcc / 64, kLdO = kAcc + 4, kSlot = pair_slot(kAcc);
  extern __shared__ __align__(16) float fsm[];
  float* ring = fsm;
  float* sds = fsm + 2 * kSlot;

  const int q0 = blockIdx.x * kRows, bh = blockIdx.y, c0 = blockIdx.z * P, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nq = max(0, min(kRows, Lq - q0)), ncols = min(P, D - c0);
  const bool rows_live = ty < nq;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = (Lk + kPanelKeys - 1) / kPanelKeys, nqk = D / kPanel, total = tiles * (nqk + 1);
  const size_t q_off = ((size_t)bh * Lq + q0) * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

  // Item i: tile i / (nqk + 1); its chunks c < nqk of Q, K, dO and V, then
  // (c == nqk) the tile's K over the block's accumulated columns.
  auto issue = [&](int i) {
    float* dst = ring + (i % 2) * kSlot;
    const int t = i / (nqk + 1), c = i % (nqk + 1), k0 = t * kPanelKeys, nk = min(kPanelKeys, Lk - k0);
    if (c == nqk) {
      stage_panel<kAcc>(dst, kLdO, kb + (size_t)k0 * D + c0, D, nk, D - c0);
    } else {
      stage_panel<kPanel>(dst, kPanelLdC, q + q_off + c * kPanel, D, nq, kPanel);
      stage_panel<kPanel>(dst + kPairChunk, kPanelLdC, kb + (size_t)k0 * D + c * kPanel, D, nk, kPanel);
      stage_panel<kPanel>(dst + 2 * kPairChunk, kPanelLdC, g + q_off + c * kPanel, D, nq, kPanel);
      stage_panel<kPanel>(dst + 3 * kPairChunk, kPanelLdC, vb + (size_t)k0 * D + c * kPanel, D, nk, kPanel);
    }
  };
  issue(0);
  cp_async_commit();

  // Each of the thread's rows: D_i over the whole head dim, a float4 in 16
  // of a row's 16 threads, and lse2.
  float dsum[4], lse2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    float part = 0.f;
    if (row < nq) {
      const float* gr = g + q_off + (size_t)row * D;
      const float* orow = out + q_off + (size_t)row * D;
      for (int d = 4 * tx; d < D; d += 64) {
        const float4 a = *reinterpret_cast<const float4*>(gr + d), b = *reinterpret_cast<const float4*>(orow + d);
        part = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, part))));
      }
    }
    dsum[r] = half_sum(part);
    lse2[r] = row < nq ? lse[(size_t)bh * Lq + q0 + row] * kLog2e : INFINITY;
    if (blockIdx.z == 0 && tx == 0) {
      lse2_pad[(size_t)bh * Lq_pad + q0 + row] = lse2[r];
      dsum_pad[(size_t)bh * Lq_pad + q0 + row] = dsum[r];
    }
  }
  const bool all_masked = !any_valid_key(mask_b, Lk);

  int i = 0;  // the item the block consumes next
  auto acquire = [&]() -> const float* {  // start item i + 1, wait for item i
    if (i + 1 < total) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return ring + (i % 2) * kSlot;
  };
  auto release = [&] {
    __syncthreads();
    ++i;
  };

  float4 o[4][kC4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC4; ++c) o[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kPanelKeys, nk = min(kPanelKeys, Lk - k0);
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < nqk; ++c) {
      const float* sl = acquire();
      if (rows_live) {
        panel_dots<kPanelLdC, kPanel>(s, sl, sl + kPairChunk, nk);                       // Q K^T
        panel_dots<kPanelLdC, kPanel>(dp, sl + 2 * kPairChunk, sl + 3 * kPairChunk, nk);  // dO V^T
      }
      release();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = key < Lk && (all_masked || mask_b == nullptr || mask_b[key]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = valid ? exp2f((all_masked ? 0.f : s[r][j] * scale_log2) - lse2[r]) : 0.f;
        sds[(ty + 16 * r) * kPanelLdP + tx + 16 * j] = p * (dp[r][j] - dsum[r]);
      }
    }
    const float* sk = acquire();  // K's columns; its barrier also publishes dS
    if (rows_live) panel_pv<kC4>(o, sds, sk, kLdO, nk);
    release();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (row >= nq) continue;
    float* drow = dq + q_off + (size_t)row * D + c0;
#pragma unroll
    for (int c = 0; c < kC4; ++c)
      if (4 * tx + 64 * c < ncols)
        *reinterpret_cast<float4*>(drow + 4 * tx + 64 * c) =
            make_float4(o[r][c].x * scale, o[r][c].y * scale, o[r][c].z * scale, o[r][c].w * scale);
  }
}

// B.4's dK/dV in float32 above head dim 128. Grid (ceil(Lk / 64), B*H,
// ceil(D / kPairOut)), kThreads threads, pair_dkdv_smem_bytes(kPairOut)
// bytes. Thread (ty, tx) holds keys ty + 16 i and, in a tile, queries
// tx + 16 j.
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const uint8_t* __restrict__ mask, const float* __restrict__ g, float* __restrict__ dk,
                       float* __restrict__ dv, const float* __restrict__ lse2_pad,
                       const float* __restrict__ dsum_pad, int H, int Lq, int Lk, int D, int Lq_pad,
                       float scale_log2, float scale) {
  constexpr int kOut = kPairOut, kC4 = kOut / 64, kLdO = kOut + 4, kSlot = pair_slot(kOut);
  extern __shared__ __align__(16) float fsm[];
  float* ring = fsm;
  float* sp = fsm + 2 * kSlot;         // P^T of the tile (key rows)
  float* sds = sp + kRows * kPanelLdP;  // dS^T

  const int k0 = blockIdx.x * kPanelKeys, bh = blockIdx.y, c0 = blockIdx.z * kOut, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nk = min(kPanelKeys, Lk - k0), ncols = min(kOut, D - c0);
  const bool rows_live = ty < nk;
  const uint8_t* mask_b = mask ? mask + (size_t)(bh / H) * Lk : nullptr;
  const int tiles = Lq_pad / kRows, nqk = D / kPanel, per = nqk + 2, total = tiles * per;
  const size_t kv_off = ((size_t)bh * Lk + k0) * D, q_base = (size_t)bh * Lq * D, pad_off = (size_t)bh * Lq_pad;

  // Item i: query tile i / per; its chunks c < nqk of K, Q, V and dO; then
  // dO's (c == nqk) and Q's (c == nqk + 1) rows over the block's columns.
  auto issue = [&](int i) {
    float* dst = ring + (i % 2) * kSlot;
    const int t = i / per, c = i % per, r0 = t * kRows, nq = max(0, min(kRows, Lq - r0));
    const float* qt = q + q_base + (size_t)r0 * D;
    const float* gt = g + q_base + (size_t)r0 * D;
    if (c >= nqk) {
      stage_panel<kOut>(dst, kLdO, (c == nqk ? gt : qt) + c0, D, nq, D - c0);
    } else {
      stage_panel<kPanel>(dst, kPanelLdC, k + kv_off + c * kPanel, D, nk, kPanel);
      stage_panel<kPanel>(dst + kPairChunk, kPanelLdC, qt + c * kPanel, D, nq, kPanel);
      stage_panel<kPanel>(dst + 2 * kPairChunk, kPanelLdC, v + kv_off + c * kPanel, D, nk, kPanel);
      stage_panel<kPanel>(dst + 3 * kPairChunk, kPanelLdC, gt + c * kPanel, D, nq, kPanel);
    }
  };
  issue(0);
  cp_async_commit();
  const bool all_masked = !any_valid_key(mask_b, Lk);
  bool valid[4];  // the thread's keys: P is 0 on a masked key and past Lk
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    valid[r] = key < Lk && (all_masked || mask_b == nullptr || mask_b[key]);
  }

  int i = 0;
  auto acquire = [&]() -> const float* {
    if (i + 1 < total) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return ring + (i % 2) * kSlot;
  };
  auto release = [&] {
    __syncthreads();
    ++i;
  };

  float4 dk_acc[4][kC4], dv_acc[4][kC4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kC4; ++c) dk_acc[r][c] = dv_acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < tiles; ++t) {
    const int r0 = t * kRows, nq = max(0, min(kRows, Lq - r0));
    float l2[4], dd[4];  // the tile's queries' lse2 (+inf past Lq) and D, read before the products
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l2[j] = lse2_pad[pad_off + r0 + tx + 16 * j];
      dd[j] = dsum_pad[pad_off + r0 + tx + 16 * j];
    }
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < nqk; ++c) {
      const float* sl = acquire();
      if (rows_live) {
        panel_dots<kPanelLdC, kPanel>(s, sl, sl + kPairChunk, nq);                       // K Q^T
        panel_dots<kPanelLdC, kPanel>(dp, sl + 2 * kPairChunk, sl + 3 * kPairChunk, nq);  // V dO^T
      }
      release();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[r] ? exp2f((all_masked ? 0.f : s[r][j] * scale_log2) - l2[j]) : 0.f;
        sp[(ty + 16 * r) * kPanelLdP + tx + 16 * j] = p;
        sds[(ty + 16 * r) * kPanelLdP + tx + 16 * j] = p * (dp[r][j] - dd[j]);
      }
    const float* sg = acquire();  // dO's columns; its barrier also publishes P^T and dS^T
    if (rows_live) panel_pv<kC4>(dv_acc, sp, sg, kLdO, nq);
    release();
    const float* sq = acquire();  // Q's columns
    if (rows_live) panel_pv<kC4>(dk_acc, sds, sq, kLdO, nq);
    release();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = ty + 16 * r;
    if (key >= nk) continue;
    float* krow = dk + kv_off + (size_t)key * D + c0;
    float* vrow = dv + kv_off + (size_t)key * D + c0;
#pragma unroll
    for (int c = 0; c < kC4; ++c)
      if (4 * tx + 64 * c < ncols) {
        const float4 a = dk_acc[r][c];
        *reinterpret_cast<float4*>(krow + 4 * tx + 64 * c) = make_float4(a.x * scale, a.y * scale, a.z * scale,
                                                                          a.w * scale);
        *reinterpret_cast<float4*>(vrow + 4 * tx + 64 * c) = dv_acc[r][c];
      }
  }
}

// ===================================================================== launch
// Dynamic shared memory of float32 K1 at D 16 and 32: K and V, the query
// tile and the mask bytes.
size_t whole_kv_f32_smem_bytes(int Lk, int D) {
  return (size_t)2 * Lk * D * sizeof(float) + (size_t)kRows * D * sizeof(float) + Lk;
}

// The 3-D TMA map of a (B*H, L, D) bf16 tensor, read in boxes of `rows`
// rows x 64 columns (a 128-byte panel, swizzled by 128 bytes) from any
// column a multiple of 64 (above 256 the panel bodies and the pair read a
// wider head 64 columns a box), and at D 16 and 32 of `rows` whole rows:
// zero past row L and past column D, and never into the next head.
bool head_map(CUtensorMap* map, const void* x, int BH, int L, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // Head dims 16 and 32 (the narrow bodies): the box is the whole row, in
  // the swizzle of the row's 32 or 64 bytes.
  const int cols = D < kPanel ? D : kPanel;
  if (cols != kPanel && cols != 32 && cols != 16) return false;
  const CUtensorMapSwizzle swizzle = cols == kPanel ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32   ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

// K2 at head dim 16 or 32: B*H x ceil(Lq / (64 kWG)) blocks of kWG
// consumer warpgroups (narrow_wg(Lq)).
template <int D>
cudaError_t launch_flash_narrow(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask, bf16* out,
                                float* lse, int B, int H, int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  const int wg = narrow_wg(Lq), rows = 64 * wg;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  constexpr int kKeys = NarrowLayout<D, 1, 1, 1>::kRing;
  if ((Lq + rows - 1) / rows > 65535 || !head_map(&tq, q, B * H, Lq, D, rows) ||
      !head_map(&tk, k, B * H, Lk, D, kKeys) || !head_map(&tv, v, B * H, Lk, D, kKeys))
    return cudaErrorInvalidValue;
  const auto kernel = wg == 1 ? attention_flash_wgmma_narrow<D, 1> : attention_flash_wgmma_narrow<D, 2>;
  const size_t smem = wg == 1 ? NarrowLayout<D, 1, 1, 1>::kSmem : NarrowLayout<D, 2, 1, 1>::kSmem;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<dim3(B * H, (Lq + rows - 1) / rows), narrow_threads(wg), smem, stream>>>(tq, tk, tv, mask, out, lse, H,
                                                                                     Lq, Lk, scale_log2);
  return cudaGetLastError();
}

// B.4's pair at head dim 16 or 32: the dQ kernel over 64-row query blocks
// (it writes the scratch, rows padded to 64), then the dK/dV kernel over
// 64-key blocks, a block all D columns; B*H on grid x in both.
template <int D>
cudaError_t launch_backward_narrow(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask,
                                   const bf16* out, const float* lse, const bf16* g, bf16* dq, bf16* dk, bf16* dv,
                                   float* lse2_pad, float* dsum_pad, int B, int H, int Lq, int Lk, int Lq_pad,
                                   float scale_log2, float scale, cudaStream_t stream) {
  using Dq = NarrowLayout<D, 1, 2, 1>;
  using Dkdv = NarrowLayout<D, 1, 2, 2>;
  const int BH = B * H;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tg, tk, tv;  // every box 64 rows: the blocks' fixed tiles and the ring's
  if (Lq_pad / Dq::kRows > 65535 || (Lk + Dkdv::kRows - 1) / Dkdv::kRows > 65535 || Lq_pad % Dq::kRows != 0 ||
      !head_map(&tq, q, BH, Lq, D, Dq::kRows) ||
      !head_map(&tg, g, BH, Lq, D, Dq::kRows) || !head_map(&tk, k, BH, Lk, D, Dq::kRing) ||
      !head_map(&tv, v, BH, Lk, D, Dq::kRing))
    return cudaErrorInvalidValue;
  if ((err = allow_smem(attention_bwd_dq_wgmma_narrow<D>, Dq::kSmem)) != cudaSuccess) return err;
  attention_bwd_dq_wgmma_narrow<D><<<dim3(BH, Lq_pad / Dq::kRows), narrow_threads(1), Dq::kSmem, stream>>>(
      tq, tg, tk, tv, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attention_bwd_dkdv_wgmma_narrow<D>, Dkdv::kSmem)) != cudaSuccess) return err;
  attention_bwd_dkdv_wgmma_narrow<D><<<dim3(BH, (Lk + Dkdv::kRows - 1) / Dkdv::kRows), narrow_threads(1),
                                       Dkdv::kSmem, stream>>>(tk, tv, tq, tg, mask, dk, dv, lse2_pad, dsum_pad, H,
                                                              Lq, Lk, Lq_pad, scale_log2, scale);
  return cudaGetLastError();
}

// The forwards that take the panel bodies: above head dim 128 bf16 K1 at
// every D and bf16 K2 above 256 (attention_panels_wgmma), float32 K1 and K2
// (attention_panels_fma); float32 K1 also at 64 and 128 (one panel, the
// whole head). flash: K2 (online softmax), else K1 (two passes).
bool panel_plan_ok(int dtype, int D, bool flash) {
  const PanelPlan p = panel_plan(D);
  if (dtype == 0 && !flash && (D == 64 || D == 128)) return true;
  return D > 128 && D % kPanel == 0 && (p.acc == 192 || p.acc == 256) && D - (p.panels - 1) * p.cols > 0;
}

size_t panel_smem_bytes(int dtype, int D) {
  const PanelPlan p = panel_plan(D);
  if (dtype == 0) return panel_f32_smem_bytes(D, p.acc);
  return p.acc == 192 ? PanelLayout<192>::smem(D == 192) : PanelLayout<256>::smem(D == 256);
}

cudaError_t launch_panels(bool flash, const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask, bf16* out,
                          float* lse, int B, int H, int Lq, int Lk, int D, float scale_log2, cudaStream_t stream) {
  if (!panel_plan_ok(1, D, flash) || B * H > 65535) return cudaErrorInvalidValue;
  const PanelPlan p = panel_plan(D);
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B * H, Lq, D, kWgRows) || !head_map(&tk, k, B * H, Lk, D, kPanelKeys) ||
      !head_map(&tv, v, B * H, Lk, D, kPanelKeys))
    return cudaErrorInvalidValue;
  const auto kernel = p.acc == 192 ? (flash ? attention_panels_wgmma<192, false> : attention_panels_wgmma<192, true>)
                                   : (flash ? attention_panels_wgmma<256, false> : attention_panels_wgmma<256, true>);
  const size_t smem = panel_smem_bytes(1, D);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const dim3 grid((Lq + kWgRows - 1) / kWgRows, B * H, p.panels);
  kernel<<<grid, kWgConsumerThreads, smem, stream>>>(tq, tk, tv, mask, out, lse, H, Lq, Lk, D, p.cols, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_panels(bool flash, const float* q, const float* k, const float* v, const uint8_t* mask,
                          float* out, float* lse, int B, int H, int Lq, int Lk, int D, float scale_log2,
                          cudaStream_t stream) {
  if (!panel_plan_ok(0, D, flash) || B * H > 65535) return cudaErrorInvalidValue;
  const PanelPlan p = panel_plan(D);
  const auto kernel = p.acc == 64    ? attention_panels_fma<64, true>
                      : p.acc == 128 ? attention_panels_fma<128, true>
                      : p.acc == 192 ? (flash ? attention_panels_fma<192, false> : attention_panels_fma<192, true>)
                                     : (flash ? attention_panels_fma<256, false> : attention_panels_fma<256, true>);
  const size_t smem = panel_smem_bytes(0, D);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int row_blocks = (Lq + kRows - 1) / kRows;  // K1 at 64 and 128: heads on x (see attention_panels_fma)
  const dim3 grid = p.acc <= 128 ? dim3(B * H, row_blocks, 1) : dim3(row_blocks, B * H, p.panels);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse, H, Lq, Lk, D, p.cols, scale_log2);
  return cudaGetLastError();
}

// K1's grid: `blocks` query-row blocks per (batch*head) of `threads`
// threads each, as kernels/attention.py::whole_kv_plan gives it (float32 at
// 64 and 128: the panel body's grid, which the launch checks the same way).
// K2's grid has no choice in it and is set here. lse may be null; K1's bf16
// body writes none and refuses a pointer.
template <int D>
cudaError_t launch_f32(bool flash, const float* q, const float* k, const float* v,
                       const uint8_t* mask, float* out, float* lse, int B, int H, int Lq, int Lk,
                       int blocks, int threads, float scale_log2, cudaStream_t stream) {
  if (flash) {  // the 3xTF32 body: ceil(Lq / 64) x B*H blocks (a head's row blocks side by side)
    if (B * H > 65535) return cudaErrorInvalidValue;
    constexpr size_t smem = Tf32Flash<D>::kSmem;
    const cudaError_t err = allow_smem(attention_flash_tf32<D>, smem);
    if (err != cudaSuccess) return err;
    attention_flash_tf32<D><<<dim3((Lq + kRows - 1) / kRows, B * H), kFlashWarps * 32, smem, stream>>>(
        q, k, v, mask, out, lse, H, Lq, Lk, scale_log2);
  } else {
    if (threads != kThreads || blocks < 1 || blocks * kRows < Lq) return cudaErrorInvalidValue;
    if constexpr (D >= 64) {  // the panel body, any Lk
      return launch_panels(false, q, k, v, mask, out, lse, B, H, Lq, Lk, D, scale_log2, stream);
    } else {
      const size_t smem = whole_kv_f32_smem_bytes(Lk, D);
      const cudaError_t err = allow_smem(attention_whole_kv_kernel<D>, smem);
      if (err != cudaSuccess) return err;
      attention_whole_kv_kernel<D><<<dim3(B * H, blocks), kThreads, smem, stream>>>(q, k, v, mask, out, lse, H, Lq,
                                                                                     Lk, scale_log2);
    }
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(bool flash, const bf16* q, const bf16* k, const bf16* v,
                        const uint8_t* mask, bf16* out, float* lse, int B, int H, int Lq, int Lk,
                        int blocks, int threads, float scale_log2, cudaStream_t stream) {
  if (flash) {  // the Hopper bodies
    if constexpr (D >= 64) return launch_flash_wgmma<D>(q, k, v, mask, out, lse, B, H, Lq, Lk, scale_log2, stream);
    else return launch_flash_narrow<D>(q, k, v, mask, out, lse, B, H, Lq, Lk, scale_log2, stream);
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
  if (flash && dtype == 1 && (D == 192 || D == 256)) {  // bf16 K2 at 192 and 256: the in-line Hopper body
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v);
    bf16* bo = static_cast<bf16*>(out);
    err = D == 192 ? launch_flash_wgmma<192>(bq, bk, bv, m, bo, l, B, H, Lq, Lk, scale_log2, s)
                   : launch_flash_wgmma<256>(bq, bk, bv, m, bo, l, B, H, Lq, Lk, scale_log2, s);
    return (int)err;
  }
  if (D > 128) {  // every other forward above 128: the panel bodies; K1's grid arguments do not apply
    if (dtype == 0)
      err = launch_panels(flash, static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), m, static_cast<float*>(out), l, B, H, Lq, Lk, D,
                          scale_log2, s);
    if (dtype == 1)
      err = launch_panels(flash, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
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

// B.4's float32 pair up to head dim 128 (3xTF32): the dQ kernel over 64-row
// query blocks (it writes the scratch, rows padded to 64), then the dK/dV
// kernel over 64-key blocks, D / kOut of them a key block (grid z).
template <int D>
cudaError_t launch_backward_tf32(const float* q, const float* k, const float* v, const uint8_t* mask,
                                 const float* out, const float* lse, const float* g, float* dq, float* dk, float* dv,
                                 float* lse2_pad, float* dsum_pad, int B, int H, int Lq, int Lk, int Lq_pad,
                                 float scale_log2, float scale, cudaStream_t stream) {
  using P = Tf32Pair<D>;
  const int BH = B * H;
  if (BH > 65535 || Lq_pad % kRows != 0) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(attention_bwd_dq_tf32<D>, P::kSmem)) != cudaSuccess) return err;
  attention_bwd_dq_tf32<D><<<dim3(Lq_pad / kRows, BH), kFlashWarps * 32, P::kSmem, stream>>>(
      q, k, v, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attention_bwd_dkdv_tf32<D>, P::kSmem)) != cudaSuccess) return err;
  attention_bwd_dkdv_tf32<D><<<dim3((Lk + kRows - 1) / kRows, BH, D / P::kOut), kFlashWarps * 32, P::kSmem,
                               stream>>>(q, k, v, mask, g, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, Lq_pad, scale_log2,
                                         scale);
  return cudaGetLastError();
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
  if constexpr (std::is_same_v<T, float>) {  // the 3xTF32 pair
    return launch_backward_tf32<D>(q, k, v, mask, out, lse, g, dq, dk, dv, lse2_pad, dsum_pad, B, H, Lq, Lk, Lq_pad,
                                   scale_log2, scale, stream);
  } else if constexpr (D >= 64) {  // the Hopper pair
    return launch_backward_wgmma<D>(q, k, v, mask, out, lse, g, dq, dk, dv, lse2_pad, dsum_pad, B, H, Lq, Lk,
                                    Lq_pad, scale_log2, scale, stream);
  } else {  // the narrow Hopper pair
    return launch_backward_narrow<D>(q, k, v, mask, out, lse, g, dq, dk, dv, lse2_pad, dsum_pad, B, H, Lq, Lk,
                                     Lq_pad, scale_log2, scale, stream);
  }
}

// B.4's pair in float32 above head dim 128: the dQ kernel over 64-row
// blocks and the forward's column panels (grid z), which writes the
// scratch, then the dK/dV kernel over 64-key blocks, ceil(D / kPairOut) of
// them a key block.
cudaError_t launch_backward_fma(const float* q, const float* k, const float* v, const uint8_t* mask,
                                const float* out, const float* lse, const float* g, float* dq, float* dk, float* dv,
                                float* scratch, int B, int H, int Lq, int Lk, int D, float scale,
                                cudaStream_t stream) {
  if (!panel_plan_ok(0, D, true) || B * H > 65535) return cudaErrorInvalidValue;
  const PanelPlan p = panel_plan(D);
  const int Lq_pad = scratch_rows(0, Lq, D);
  float* lse2_pad = scratch;
  float* dsum_pad = scratch + (size_t)B * H * Lq_pad;
  const float scale_log2 = kLog2e * scale;
  const auto dq_kernel = p.acc == 192 ? attention_bwd_dq_fma<192> : attention_bwd_dq_fma<256>;
  cudaError_t err;
  if ((err = allow_smem(dq_kernel, pair_dq_smem_bytes(p.acc))) != cudaSuccess) return err;
  dq_kernel<<<dim3(Lq_pad / kRows, B * H, p.panels), kThreads, pair_dq_smem_bytes(p.acc), stream>>>(
      q, k, v, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, D, p.cols, Lq_pad, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attention_bwd_dkdv_fma, pair_dkdv_smem_bytes(kPairOut))) != cudaSuccess) return err;
  attention_bwd_dkdv_fma<<<dim3((Lk + kPanelKeys - 1) / kPanelKeys, B * H, (D + kPairOut - 1) / kPairOut), kThreads,
                           pair_dkdv_smem_bytes(kPairOut), stream>>>(
      q, k, v, mask, g, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, D, Lq_pad, scale_log2, scale);
  return cudaGetLastError();
}

// B.4's pair in bf16 above head dim 256: the dQ kernel over 128-row blocks
// and the forward's column panels (grid z), which writes the scratch (rows
// padded to 128), then the dK/dV kernel over 128-key blocks, ceil(D / 128)
// column blocks of 128 a key block.
cudaError_t launch_backward_panels(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask, const bf16* out,
                                   const float* lse, const bf16* g, bf16* dq, bf16* dk, bf16* dv, float* scratch,
                                   int B, int H, int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  if (D <= 256 || !panel_plan_ok(1, D, true) || B * H > 65535) return cudaErrorInvalidValue;
  const PanelPlan p = panel_plan(D);
  const int BH = B * H, Lq_pad = scratch_rows(1, Lq, D);
  float* lse2_pad = scratch;
  float* dsum_pad = scratch + (size_t)BH * Lq_pad;
  const float scale_log2 = kLog2e * scale;
  const int keys = p.acc == 256 ? PairDqLayout<256>::kKeys : PairDqLayout<192>::kKeys;
  cudaError_t err = bind_device(q);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tg, tk, tv, tk2, tv2, tq2, tg2;
  constexpr int kR = PairDkdvLayout::kRowsQ;
  if (!head_map(&tq, q, BH, Lq, D, kWgRows) || !head_map(&tg, g, BH, Lq, D, kWgRows) ||
      !head_map(&tk, k, BH, Lk, D, keys) || !head_map(&tv, v, BH, Lk, D, keys) ||
      !head_map(&tk2, k, BH, Lk, D, kWgRows) || !head_map(&tv2, v, BH, Lk, D, kWgRows) ||
      !head_map(&tq2, q, BH, Lq, D, kR) || !head_map(&tg2, g, BH, Lq, D, kR))
    return cudaErrorInvalidValue;
  const auto dq_kernel = p.acc == 192 ? attention_bwd_dq_wgmma_panels<192> : attention_bwd_dq_wgmma_panels<256>;
  const size_t dq_smem = p.acc == 192 ? PairDqLayout<192>::kSmem : PairDqLayout<256>::kSmem;
  if ((err = allow_smem(dq_kernel, dq_smem)) != cudaSuccess) return err;
  dq_kernel<<<dim3(Lq_pad / kWgRows, BH, p.panels), kWgConsumerThreads, dq_smem, stream>>>(
      tq, tg, tk, tv, mask, out, lse, g, dq, lse2_pad, dsum_pad, H, Lq, Lk, D, p.cols, Lq_pad, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attention_bwd_dkdv_wgmma_panels, PairDkdvLayout::kSmem)) != cudaSuccess) return err;
  attention_bwd_dkdv_wgmma_panels<<<dim3((Lk + kWgRows - 1) / kWgRows, BH,
                                         (D + PairDkdvLayout::kCols - 1) / PairDkdvLayout::kCols),
                                    kWgConsumerThreads, PairDkdvLayout::kSmem, stream>>>(
      tk2, tv2, tq2, tg2, mask, dk, dv, lse2_pad, dsum_pad, H, Lq, Lk, D, Lq_pad, scale_log2, scale);
  return cudaGetLastError();
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
  if (D <= 128) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float>) {  // float32 above 128: the register-tiled pair
    return launch_backward_fma(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, D, scale, stream);
  } else {  // bf16 above 256: the wgmma pair on column panels
    return launch_backward_panels(tq, tk, tv, m, to, l, tg, tdq, tdk, tdv, sc, B, H, Lq, Lk, D, scale, stream);
  }
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
    {"attention_flash_wgmma_narrow<bf16,16,1>", (const void*)attention_flash_wgmma_narrow<16, 1>},
    {"attention_flash_wgmma_narrow<bf16,16,2>", (const void*)attention_flash_wgmma_narrow<16, 2>},
    {"attention_flash_wgmma_narrow<bf16,32,1>", (const void*)attention_flash_wgmma_narrow<32, 1>},
    {"attention_flash_wgmma_narrow<bf16,32,2>", (const void*)attention_flash_wgmma_narrow<32, 2>},
    {"attention_flash_wgmma<bf16,64>", (const void*)attention_flash_wgmma<64>},
    {"attention_flash_wgmma<bf16,128>", (const void*)attention_flash_wgmma<128>},
    {"attention_flash_wgmma_inline<bf16,192>", (const void*)attention_flash_wgmma_inline<192>},
    {"attention_flash_wgmma_inline<bf16,256>", (const void*)attention_flash_wgmma_inline<256>},
    {"attention_whole_kv_kernel<float,16>", (const void*)attention_whole_kv_kernel<16>},
    {"attention_whole_kv_kernel<float,32>", (const void*)attention_whole_kv_kernel<32>},
    {"attention_flash_tf32<float,16>", (const void*)attention_flash_tf32<16>},
    {"attention_flash_tf32<float,32>", (const void*)attention_flash_tf32<32>},
    {"attention_flash_tf32<float,64>", (const void*)attention_flash_tf32<64>},
    {"attention_flash_tf32<float,128>", (const void*)attention_flash_tf32<128>},
    {"attention_bwd_dq_wgmma_narrow<bf16,16>", (const void*)attention_bwd_dq_wgmma_narrow<16>},
    {"attention_bwd_dq_wgmma_narrow<bf16,32>", (const void*)attention_bwd_dq_wgmma_narrow<32>},
    {"attention_bwd_dq_wgmma<bf16,64>", (const void*)attention_bwd_dq_wgmma<64>},
    {"attention_bwd_dq_wgmma<bf16,128>", (const void*)attention_bwd_dq_wgmma<128>},
    {"attention_bwd_dq_wgmma_inline<bf16,192>", (const void*)attention_bwd_dq_wgmma_inline<192>},
    {"attention_bwd_dq_wgmma_inline<bf16,256>", (const void*)attention_bwd_dq_wgmma_inline<256>},
    {"attention_bwd_dkdv_wgmma_narrow<bf16,16>", (const void*)attention_bwd_dkdv_wgmma_narrow<16>},
    {"attention_bwd_dkdv_wgmma_narrow<bf16,32>", (const void*)attention_bwd_dkdv_wgmma_narrow<32>},
    {"attention_bwd_dkdv_wgmma<bf16,64>", (const void*)attention_bwd_dkdv_wgmma<64>},
    {"attention_bwd_dkdv_wgmma<bf16,128>", (const void*)attention_bwd_dkdv_wgmma<128>},
    {"attention_bwd_dkdv_wgmma<bf16,192>", (const void*)attention_bwd_dkdv_wgmma<192>},
    {"attention_bwd_dkdv_wgmma<bf16,256>", (const void*)attention_bwd_dkdv_wgmma<256>},
    {"attention_bwd_dq_tf32<float,16>", (const void*)attention_bwd_dq_tf32<16>},
    {"attention_bwd_dq_tf32<float,32>", (const void*)attention_bwd_dq_tf32<32>},
    {"attention_bwd_dq_tf32<float,64>", (const void*)attention_bwd_dq_tf32<64>},
    {"attention_bwd_dq_tf32<float,128>", (const void*)attention_bwd_dq_tf32<128>},
    {"attention_bwd_dkdv_tf32<float,16>", (const void*)attention_bwd_dkdv_tf32<16>},
    {"attention_bwd_dkdv_tf32<float,32>", (const void*)attention_bwd_dkdv_tf32<32>},
    {"attention_bwd_dkdv_tf32<float,64>", (const void*)attention_bwd_dkdv_tf32<64>},
    {"attention_bwd_dkdv_tf32<float,128>", (const void*)attention_bwd_dkdv_tf32<128>},
    {"attention_panels_wgmma<bf16,192,K1>", (const void*)attention_panels_wgmma<192, true>},
    {"attention_panels_wgmma<bf16,256,K1>", (const void*)attention_panels_wgmma<256, true>},
    {"attention_panels_wgmma<bf16,192,K2>", (const void*)attention_panels_wgmma<192, false>},
    {"attention_panels_wgmma<bf16,256,K2>", (const void*)attention_panels_wgmma<256, false>},
    {"attention_panels_fma<float,64,K1>", (const void*)attention_panels_fma<64, true>},
    {"attention_panels_fma<float,128,K1>", (const void*)attention_panels_fma<128, true>},
    {"attention_panels_fma<float,192,K1>", (const void*)attention_panels_fma<192, true>},
    {"attention_panels_fma<float,256,K1>", (const void*)attention_panels_fma<256, true>},
    {"attention_panels_fma<float,192,K2>", (const void*)attention_panels_fma<192, false>},
    {"attention_panels_fma<float,256,K2>", (const void*)attention_panels_fma<256, false>},
    {"attention_bwd_dq_fma<float,192>", (const void*)attention_bwd_dq_fma<192>},
    {"attention_bwd_dq_fma<float,256>", (const void*)attention_bwd_dq_fma<256>},
    {"attention_bwd_dkdv_fma<float>", (const void*)attention_bwd_dkdv_fma},
    {"attention_bwd_dq_wgmma_panels<bf16,192>", (const void*)attention_bwd_dq_wgmma_panels<192>},
    {"attention_bwd_dq_wgmma_panels<bf16,256>", (const void*)attention_bwd_dq_wgmma_panels<256>},
    {"attention_bwd_dkdv_wgmma_panels<bf16>", (const void*)attention_bwd_dkdv_wgmma_panels},
};

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mask: (B, Lk) bytes (torch.bool), or null for no mask. lse: (B, H, Lq)
// float32, or null to write none. D: 16, 32, 64, 128 (float32 K2 on the
// 3xTF32 body), or a multiple of 64 above 128 (bf16 K2 at 192 and 256 on
// the in-line Hopper body, every other forward there on the panel bodies,
// which take any lse, and set their own grid); scale: the softmax scale, 1/sqrt of the head dim before any zero
// padding (the wrapper pads other head dims). stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 = success). K1 up to 128 takes
// its grid (blocks per batch*head, threads a block) from
// kernels/attention.py::whole_kv_plan, and refuses one that leaves query
// rows without a warp, and an lse pointer in bf16 (cudaErrorInvalidValue).
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

// The panel plan of a forward above head dim 128 at this dtype and head
// dim D (a multiple of 64), and of float32 K1 at 64 and 128: blocks on grid
// z, output columns a block (the last one D - (panels - 1) cols), columns a
// block accumulates, and dynamic shared bytes a block. Returns
// cudaErrorInvalidValue for a dtype or D the panel bodies do not take.
extern "C" int attention_forward_plan(int dtype, int D, int* panels, int* cols, int* acc, int* smem) {
  if ((dtype != 0 && dtype != 1) || !panel_plan_ok(dtype, D, false)) return (int)cudaErrorInvalidValue;
  const PanelPlan p = panel_plan(D);
  *panels = p.panels;
  *cols = p.cols;
  *acc = p.acc;
  *smem = (int)panel_smem_bytes(dtype, D);
  return 0;
}

// The float32 pair's plan above head dim 128 at head dim D (a multiple of
// 64): the dQ kernel's column panels on grid z, output columns a block (the
// last one D - (panels - 1) cols), columns it accumulates and its dynamic
// shared bytes; then the dK/dV kernel's column blocks on grid z, output
// columns a block (the last one D - (blocks - 1) cols) and its shared
// bytes. Returns cudaErrorInvalidValue for a D the pair does not take.
extern "C" int attention_backward_plan(int D, int* dq_panels, int* dq_cols, int* dq_acc, int* dq_smem,
                                       int* dkdv_blocks, int* dkdv_cols, int* dkdv_smem) {
  if (!panel_plan_ok(0, D, true)) return (int)cudaErrorInvalidValue;
  const PanelPlan p = panel_plan(D);
  *dq_panels = p.panels;
  *dq_cols = p.cols;
  *dq_acc = p.acc;
  *dq_smem = (int)pair_dq_smem_bytes(p.acc);
  *dkdv_blocks = (D + kPairOut - 1) / kPairOut;
  *dkdv_cols = kPairOut;
  *dkdv_smem = (int)pair_dkdv_smem_bytes(kPairOut);
  return 0;
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
