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
//
// What bounds it on an H100. At DETR's head dim 32 a query row does 2*D = 64
// FLOPs per key for QK^T and as many for P.V, while a key costs 2*D*2 bytes
// of K and V in bf16: the (batch*head) tile is reused by every query row, so
// the work is bound by operations, not bytes (DETR's encoder call
// (8,8,920,920,32) in bf16: 6.9 GFLOP against 15 MB of q, k, v and out; K1's
// two passes compute QK^T twice, 1.5x that). These kernels run them as float32 FMAs
// on the CUDA cores, not on the tensor cores, so their ceiling is the
// card's non-tensor float32 rate (67 TFLOP/s), far below the 989 TFLOP/s
// bf16 tensor-core bound. That is the price of a first, simple kernel; a
// later change moves QK^T and P.V to mma/wgmma.
//
// Design.
//  * Grid (B*H, ceil(Lq/64)); 256 threads; thread t owns query row t/4 of the
//    64-row tile and the keys j = 4*i + t%4. The four threads of a row are
//    adjacent lanes and combine their partial max, sum and output with
//    warp shuffles at the end. Ragged Lq and Lk are masked in the kernel: no
//    padding to 128 as on the TPU.
//  * The mask is (B, Lk) bytes and is read per batch, not repeated per head.
//  * K1 stages the head's whole K and V (and the query tile) in dynamic shared
//    memory once, then runs an exact two-pass softmax per row: pass 1 the row
//    max and normalizer, pass 2 p = exp(s - max) / sum, rounded to T, times V.
//    That is _fused_attn_kernel's rounding (probs.astype(v.dtype) before P.V).
//  * K2 walks K/V in 64-key tiles with an online max and normalizer per
//    thread. The loop inside the block replaces the TPU's sequential KV grid
//    axis, which has no counterpart on the GPU. As in _flash_attn_kernel the
//    unnormalized p = exp(s - running max) is rounded to T before P.V, and the
//    sum is divided out at the end.
//  * K and V rows live in shared memory with their 16-byte chunks XOR-swizzled
//    by key, so that the four keys a quarter-warp reads at once fall in
//    different banks.
//  * A batch entry whose keys are all masked gives mean(V) over its Lk keys,
//    as the plain version (attention_reference) does: all keys count as
//    valid with score 0. DETR's pixel mask never produces one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kRows = 64;              // query rows per block
constexpr int kSplit = 4;              // threads per query row
constexpr int kThreads = kRows * kSplit;
constexpr int kFlashKeys = 64;         // keys per K2 tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float to T and back: the probabilities enter P.V in V's type.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int D> struct Layout {
  static constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte chunk
  static constexpr int kChunks = D / kVec;            // chunks per row
  static constexpr int kRowBytes = D * sizeof(T);
  static constexpr int kRowsPerLine = kRowBytes >= 128 ? 1 : 128 / kRowBytes;
  static constexpr int kSwizzle = kChunks < 4 ? kChunks : 4;
  // Physical chunk of logical chunk c in row j.
  __device__ __forceinline__ static int chunk(int j, int c) {
    return c ^ ((j / kRowsPerLine) % kSwizzle);
  }
};

// Unpack one 16-byte chunk into floats.
template <typename T> __device__ __forceinline__ void unpack(const uint4& raw, float* out);
template <> __device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy rows [0, n) of a (n, D) row-major global array into swizzled shared rows.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int n) {
  using L = Layout<T, D>;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int e = threadIdx.x; e < n * L::kChunks; e += kThreads) {
    const int j = e / L::kChunks, c = e % L::kChunks;
    d[j * L::kChunks + L::chunk(j, c)] = s[e];
  }
}

// q . k_j for one swizzled shared row j.
template <typename T, int D>
__device__ __forceinline__ float dot_row(const T* rows, int j, const float* q) {
  using L = Layout<T, D>;
  const uint4* r = reinterpret_cast<const uint4*>(rows) + j * L::kChunks;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    float x[L::kVec];
    unpack<T>(r[L::chunk(j, c)], x);
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) acc = fmaf(q[c * L::kVec + e], x[e], acc);
  }
  return acc;
}

// acc += p * v_j for one swizzled shared row j.
template <typename T, int D>
__device__ __forceinline__ void axpy_row(const T* rows, int j, float p, float* acc) {
  using L = Layout<T, D>;
  const uint4* r = reinterpret_cast<const uint4*>(rows) + j * L::kChunks;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    float x[L::kVec];
    unpack<T>(r[L::chunk(j, c)], x);
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) acc[c * L::kVec + e] = fmaf(p, x[e], acc[c * L::kVec + e]);
  }
}

// Load this thread's query row (unswizzled, row-major global) as floats.
template <typename T, int D>
__device__ __forceinline__ void load_query(const T* qrow, float* q) {
  using L = Layout<T, D>;
  const uint4* r = reinterpret_cast<const uint4*>(qrow);
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) unpack<T>(r[c], q + c * L::kVec);
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
template <typename T, int D>
__device__ __forceinline__ void write_row(float* acc, float inv, T* orow, int split, bool live) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d / (D / kSplit) == split) orow[d] = from_float<T>(acc[d] * inv);
  }
}

// Stage the batch entry's mask bytes for keys [k0, k0 + n); returns (via the
// block) whether any key of the whole entry is valid.
__device__ __forceinline__ void stage_mask(uint8_t* dst, const uint8_t* mask_b, int k0, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = mask_b ? (mask_b[k0 + j] != 0) : 1;
}

__device__ __forceinline__ int any_valid_key(const uint8_t* mask_b, int Lk) {
  int any = 0;
  if (mask_b == nullptr) {
    any = 1;
  } else {
    for (int j = threadIdx.x; j < Lk && !any; j += kThreads) any = mask_b[j] != 0;
  }
  return __syncthreads_or(any);
}

// ---------------------------------------------------------------- K1
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_whole_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ mask,
                          T* __restrict__ out, int H, int Lq, int Lk, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + (size_t)Lk * D;
  T* sq = sv + (size_t)Lk * D;
  uint8_t* smask = reinterpret_cast<uint8_t*>(sq + kRows * D);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Lq - q0);
  const size_t kv_off = (size_t)bh * Lk * D;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  stage_rows<T, D>(sk, k + kv_off, Lk);
  stage_rows<T, D>(sv, v + kv_off, Lk);
  {
    const uint4* s = reinterpret_cast<const uint4*>(q + ((size_t)bh * Lq + q0) * D);
    uint4* d = reinterpret_cast<uint4*>(sq);
    for (int e = threadIdx.x; e < nq * Layout<T, D>::kChunks; e += kThreads) d[e] = s[e];
  }
  stage_mask(smask, mask_b, 0, Lk);
  const bool all_masked = !any_valid_key(mask_b, Lk);  // also the barrier for the staging

  const int row = threadIdx.x / kSplit;
  const int split = threadIdx.x % kSplit;
  const bool live = row < nq;
  float qf[D];
  load_query<T, D>(sq + (live ? row : 0) * D, qf);

  // Pass 1: row max and normalizer (online over this thread's keys).
  float m = -INFINITY, l = 0.f;
  if (live) {
    for (int j = split; j < Lk; j += kSplit) {
      if (!all_masked && !smask[j]) continue;
      const float s = all_masked ? 0.f : dot_row<T, D>(sk, j, qf) * scale_log2;
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

  // Pass 2: normalized probabilities, rounded to T, times V.
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (live) {
    for (int j = split; j < Lk; j += kSplit) {
      if (!all_masked && !smask[j]) continue;
      const float s = all_masked ? 0.f : dot_row<T, D>(sk, j, qf) * scale_log2;
      axpy_row<T, D>(sv, j, round_to<T>(exp2f(s - m) * inv_l), acc);
    }
  }
  write_row<T, D>(acc, 1.f, out + ((size_t)bh * Lq + q0 + row) * D, split, live);
}

// ---------------------------------------------------------------- K2
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int H, int Lq, int Lk, float scale_log2) {
  __shared__ __align__(16) T sk[kFlashKeys * D];
  __shared__ __align__(16) T sv[kFlashKeys * D];
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
  load_query<T, D>(q + ((size_t)bh * Lq + q0 + (live ? row : 0)) * D, qf);

  constexpr int kPer = kFlashKeys / kSplit;  // keys per thread per tile
  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kFlashKeys) {
    const int nk = min(kFlashKeys, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, D>(sk, k + kv_off + (size_t)k0 * D, nk);
    stage_rows<T, D>(sv, v + kv_off + (size_t)k0 * D, nk);
    stage_mask(smask, mask_b, k0, nk);
    __syncthreads();
    if (!live) continue;

    float s[kPer];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = i * kSplit + split;
      const bool valid = j < nk && (all_masked || smask[j]);
      s[i] = !valid ? -INFINITY : (all_masked ? 0.f : dot_row<T, D>(sk, j, qf) * scale_log2);
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
      axpy_row<T, D>(sv, i * kSplit + split, round_to<T>(p), acc);
    }
    m = m_new;
  }

  float self_scale;
  merge_stats(m, l, self_scale);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= self_scale;
  write_row<T, D>(acc, live ? 1.f / l : 0.f, out + ((size_t)bh * Lq + q0 + row) * D, split, live);
}

template <typename T, int D>
size_t whole_kv_smem_bytes(int Lk) {
  return (size_t)2 * Lk * D * sizeof(T) + (size_t)kRows * D * sizeof(T) + Lk;
}

template <typename T, int D>
cudaError_t launch(bool flash, const void* q, const void* k, const void* v, const void* mask,
                   void* out, int B, int H, int Lq, int Lk, cudaStream_t stream) {
  const dim3 grid(B * H, (Lq + kRows - 1) / kRows);
  const float scale_log2 = kLog2e / std::sqrt((float)D);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const uint8_t* tm = static_cast<const uint8_t*>(mask);
  T* to = static_cast<T*>(out);
  if (flash) {
    attention_flash_kernel<T, D><<<grid, kThreads, 0, stream>>>(tq, tk, tv, tm, to, H, Lq, Lk,
                                                                scale_log2);
  } else {
    const size_t smem = whole_kv_smem_bytes<T, D>(Lk);
    cudaError_t err = cudaFuncSetAttribute(attention_whole_kv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attention_whole_kv_kernel<T, D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, tm, to, H, Lq,
                                                                      Lk, scale_log2);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(bool flash, const void* q, const void* k, const void* v, const void* mask,
                     void* out, int B, int H, int Lq, int Lk, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(flash, q, k, v, mask, out, B, H, Lq, Lk, stream);
    case 32: return launch<T, 32>(flash, q, k, v, mask, out, B, H, Lq, Lk, stream);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool flash, int dtype, const void* q, const void* k, const void* v,
             const void* mask, void* out, int B, int H, int Lq, int Lk, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(flash, q, k, v, mask, out, B, H, Lq, Lk, D, s);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(flash, q, k, v, mask, out, B, H, Lq, Lk, D, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mask: (B, Lk) bytes (torch.bool), or null for no mask. stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int attention_whole_kv(int dtype, const void* q, const void* k, const void* v,
                                  const void* mask, void* out, int B, int H, int Lq, int Lk,
                                  int D, void* stream) {
  return dispatch(false, dtype, q, k, v, mask, out, B, H, Lq, Lk, D, stream);
}

extern "C" int attention_flash(int dtype, const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int H, int Lq, int Lk, int D,
                               void* stream) {
  return dispatch(true, dtype, q, k, v, mask, out, B, H, Lq, Lk, D, stream);
}

// The message of a cudaError_t, for every kernel of the library.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
