// Identity ResNet bottleneck with frozen BN folded into the weights,
// hand-written for Hopper (sm_90a):
//
//   y1  = round_T(relu(x . W1 + b1))            1x1 reduce   C -> M
//   y2  = round_T(relu(conv3x3_SAME(y1, W2) + b2))  3x3      M -> M
//   out = round_T(relu((y2 . W3 + b3) + x))     1x1 expand   M -> C
//
// x and out (B, H, W, C) NHWC contiguous; W1 (C, M), W2 (3, 3, M, M) HWIO,
// W3 (M, C) in T = float or bfloat16; biases float32. Every product
// accumulates in float32 and then adds its bias; y1 and y2 are rounded to T
// where the plain version (ops/fused_bottleneck.py::bottleneck_reference)
// rounds them; the residual is added in float32. SAME padding is zero in y1
// (after the ReLU), not relu(b1).
//
// Replaces office_person_detection_vit_tpu/ops/fused_bottleneck.py
// fused_bottleneck / _kernel (K3).
//
// What bounds it on an H100. The block reads x once and writes out once, and
// keeps y1 and y2 on the chip: at the stage-1 geometry (16,184,320,256, M 64)
// in bf16 that is 0.965 GB (0.288 ms at 3.35 TB/s) against 131 GFLOP (0.133
// ms at the 989 TFLOP/s bf16 tensor-core rate), so the work is bound by bytes.
// This first kernel runs its products as float32 FMAs on the CUDA cores, whose
// rate (67 TFLOP/s) puts it far above that bound: 131 GFLOP take 2 ms at the
// FMA peak. Moving the products to the tensor cores is a later change.
//
// Design. The TPU kernel DMAs a haloed slab of whole image rows into VMEM and
// keeps all three weight matrices there; neither fits in the 227 KB of shared
// memory a Hopper block has (W2 alone is 4.7 MB at stage 4). So:
//  * A block owns a TH x TW patch of output pixels (TH = tile_h; TW is chosen
//    by the wrapper from a shared-memory budget, kernels/bottleneck.py::plan).
//    It computes y1 on the (TH+2) x (TW+2) ring around the patch (the halo is
//    recomputed by each neighbour) and keeps it in shared memory, then y2 on
//    the patch into shared memory, then the expand, the residual and the
//    output straight to device memory.
//  * Each of the three products is a GEMM of a ROWS x K operand A (ring
//    positions or patch pixels) with a K x N weight matrix, done in ROWS x NT
//    output tiles (ROWS * NT = 4096, 16 outputs per thread in a 4 x 4 register
//    tile). A and the weights go through shared memory in K chunks of 32, as
//    float (A transposed, so a thread reads its four rows as one float4).
//    The 3x3 is nine shifted products over the ring (no im2col); W2 is
//    streamed by tap and chunk and never held whole.
//  * Ring positions outside the image get no x loads and are set to 0 after
//    the ReLU, so the SAME padding is exact and the input is never padded.
//  * One block per patch; blocks are independent, so there is no carried
//    state between grid steps and no double-buffered DMA as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // K chunk staged per step
constexpr int kBlockSmem = 232448;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 16-byte vector of T: kVec elements.
template <typename T> struct Vec {
  static constexpr int kVec = 16 / sizeof(T);
};

// Unpack one 16-byte vector of T into floats.
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

// Four consecutive T as floats, and back (residual and output).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

template <int ROWS> struct Tile {
  static constexpr int kNT = 4096 / ROWS;   // output columns of a tile
  static constexpr int kTX = kNT / 4;       // threads along the columns
  static constexpr int kAStride = ROWS + 4; // floats per k row of A (keeps float4 alignment)
};

// Ws[k][n] = W[k0 + k][n0 + n] as float for k < kKC, n < NT; zero past K or N.
// W is (K, N) row-major in T with N % 8 == 0.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_w(float* Ws, const T* __restrict__ w, int K, int N, int k0,
                                        int n0) {
  using L = Tile<ROWS>;
  constexpr int V = Vec<T>::kVec;
  constexpr int kPerRow = L::kNT / V;
  for (int e = threadIdx.x; e < kKC * kPerRow; e += kThreads) {
    const int k = e / kPerRow, c = (e % kPerRow) * V;
    float v[V];
    if (k0 + k < K && n0 + c < N) {
      unpack<T>(*reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * N + n0 + c), v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(Ws + k * L::kNT + c + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// As[k][p] = src_row(p)[k0 + k] as float, transposed; zero where the row is
// absent (src_row returns null) or past K. Rows are 16-byte aligned in T.
template <typename T, int ROWS, typename RowFn>
__device__ __forceinline__ void stage_a(float* As, int K, int k0, RowFn src_row) {
  using L = Tile<ROWS>;
  constexpr int V = Vec<T>::kVec;
  constexpr int kPerRow = kKC / V;
  for (int e = threadIdx.x; e < ROWS * kPerRow; e += kThreads) {
    const int p = e / kPerRow, c = (e % kPerRow) * V;
    const T* row = src_row(p);
    float v[V];
    if (row != nullptr && k0 + c < K) {
      unpack<T>(*reinterpret_cast<const uint4*>(row + k0 + c), v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) As[(c + i) * L::kAStride + p] = v[i];
  }
}

// acc[i][j] += sum_k As[k][4 ty + i] * Ws[k][4 tx + j] over one chunk.
template <int ROWS>
__device__ __forceinline__ void fma_chunk(const float* As, const float* Ws, float (&acc)[4][4],
                                          int ty, int tx) {
  using L = Tile<ROWS>;
#pragma unroll 8
  for (int k = 0; k < kKC; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * L::kAStride + 4 * ty);
    const float4 w = *reinterpret_cast<const float4*>(Ws + k * L::kNT + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                  const T* __restrict__ w2, const float* __restrict__ b2,
                  const T* __restrict__ w3, const float* __restrict__ b3, T* __restrict__ out,
                  int H, int W, int C, int M, int TH, int TW) {
  using L = Tile<ROWS>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = As + kKC * L::kAStride;
  T* ring = reinterpret_cast<T*>(Ws + kKC * L::kNT);  // (R, M): y1 on the ring
  const int TW2 = TW + 2;
  const int R = (TH + 2) * TW2;
  const int P = TH * TW;
  T* y2 = ring + (size_t)R * M;  // (P, M)

  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const T* xb = x + (size_t)blockIdx.z * H * W * C;
  T* ob = out + (size_t)blockIdx.z * H * W * C;
  const int ty = threadIdx.x / L::kTX, tx = threadIdx.x % L::kTX;
  float acc[4][4];

  // Image pixel of ring position r, or false outside the image.
  auto ring_pixel = [&](int r, int& h, int& w) {
    h = h0 - 1 + r / TW2;
    w = w0 - 1 + r % TW2;
    return r < R && h >= 0 && h < H && w >= 0 && w < W;
  };

  // ---- 1. y1 = relu(x . W1 + b1) on the ring, 0 outside the image
  for (int r0 = 0; r0 < R; r0 += ROWS) {
    for (int n0 = 0; n0 < M; n0 += L::kNT) {
      zero(acc);
      for (int k0 = 0; k0 < C; k0 += kKC) {
        __syncthreads();
        stage_a<T, ROWS>(As, C, k0, [&](int p) -> const T* {
          int h, w;
          return ring_pixel(r0 + p, h, w) ? xb + ((size_t)h * W + w) * C : nullptr;
        });
        stage_w<T, ROWS>(Ws, w1, C, M, k0, n0);
        __syncthreads();
        fma_chunk<ROWS>(As, Ws, acc, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * ty + i;
        int h, w;
        const bool inside = ring_pixel(r, h, w);
        if (r >= R) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 4 * tx + j;
          if (n < M) ring[(size_t)r * M + n] = from_float<T>(inside ? fmaxf(acc[i][j] + b1[n], 0.f) : 0.f);
        }
      }
    }
  }

  // ---- 2. y2 = relu(conv3x3(y1) + b2) on the patch: nine shifted products
  for (int n0 = 0; n0 < M; n0 += L::kNT) {
    zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      for (int m0 = 0; m0 < M; m0 += kKC) {
        __syncthreads();
        stage_a<T, ROWS>(As, M, m0, [&](int p) -> const T* {
          return p < P ? ring + (size_t)((p / TW + ky) * TW2 + p % TW + kx) * M : nullptr;
        });
        stage_w<T, ROWS>(Ws, w2 + (size_t)tap * M * M, M, M, m0, n0);
        __syncthreads();
        fma_chunk<ROWS>(As, Ws, acc, ty, tx);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * ty + i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n < M) y2[(size_t)p * M + n] = from_float<T>(fmaxf(acc[i][j] + b2[n], 0.f));
      }
    }
  }

  // ---- 3. out = relu((y2 . W3 + b3) + x) on the patch
  for (int n0 = 0; n0 < C; n0 += L::kNT) {
    zero(acc);
    for (int k0 = 0; k0 < M; k0 += kKC) {
      __syncthreads();
      stage_a<T, ROWS>(As, M, k0, [&](int p) -> const T* {
        return p < P ? y2 + (size_t)p * M : nullptr;
      });
      stage_w<T, ROWS>(Ws, w3, M, C, k0, n0);
      __syncthreads();
      fma_chunk<ROWS>(As, Ws, acc, ty, tx);
    }
    const int n = n0 + 4 * tx;  // C % 8 == 0: the four columns are all in or all out
    if (n >= C) continue;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = b3[n + j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * ty + i;
      const int h = h0 + p / TW, w = w0 + p % TW;
      if (p >= P || w >= W) continue;
      const size_t off = ((size_t)h * W + w) * C + n;
      float res[4], v[4];
      load4(xb + off, res);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf((acc[i][j] + bias[j]) + res[j], 0.f);
      store4(ob + off, v);
    }
  }
}

template <int ROWS>
size_t smem_bytes(int TH, int TW, int M, size_t item) {
  const size_t R = (size_t)(TH + 2) * (TW + 2);
  return (size_t)kKC * Tile<ROWS>::kAStride * 4 + (size_t)kKC * Tile<ROWS>::kNT * 4 +
         (R + (size_t)TH * TW) * M * item;
}

template <typename T, int ROWS>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, void* out, int B, int H,
                   int W, int C, int M, int TH, int TW, cudaStream_t stream) {
  if (TH < 1 || TW < 1 || TH * TW > ROWS || H % TH != 0 || C % 8 != 0 || M % 8 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<ROWS>(TH, TW, M, sizeof(T));
  if (smem > (size_t)kBlockSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, H / TH, B);
  bottleneck_kernel<T, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<const T*>(w3), b3, static_cast<T*>(out), H, W, C, M, TH, TW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(int rows, const void* x, const void* w1, const float* b1, const void* w2,
                        const float* b2, const void* w3, const float* b3, void* out, int B,
                        int H, int W, int C, int M, int TH, int TW, cudaStream_t s) {
  switch (rows) {
    case 64: return launch<T, 64>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, TH, TW, s);
    case 32: return launch<T, 32>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, TH, TW, s);
    case 16: return launch<T, 16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, TH, TW, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// rows: the GEMM tile's row count (64, 32 or 16); tile_h x tile_w pixels per
// block with tile_h * tile_w <= rows. stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int fused_bottleneck(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* w3, const void* b3,
                                void* out, int B, int H, int W, int C, int M, int tile_h,
                                int tile_w, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_rows<float>(rows, x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, C, M, tile_h,
                             tile_w, s);
  } else if (dtype == 1) {
    err = launch_rows<__nv_bfloat16>(rows, x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, C, M,
                                     tile_h, tile_w, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
