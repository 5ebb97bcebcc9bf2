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
// What bounds it on an H100. A block reads x once and writes out once, and
// keeps y1 and y2 on the chip. In bf16, for DETR-R50's identity blocks at
// 736x1280, batch 8 (65.6 GFLOP each, 0.0663 ms at the 989 TFLOP/s
// tensor-core rate): stage 1 (184x320, C 256) moves 482 MB (0.1440 ms at
// 3.35 TB/s) and stage 2 (92x160, C 512) 241 MB (0.0722 ms), so both are
// bound by bytes; stages 3 and 4 (C 1024, 2048) move less and are bound by
// operations (0.0663 ms). What the kernel really moves is more: each block
// reads all three weight matrices from L2 and recomputes y1 on a halo.
//
// Two bodies, one contract:
//
// bf16 (bottleneck_mma, tensor cores).
//  * A block owns a TH x TW patch of output pixels (TH = tile_h, TW chosen by
//    kernels/bottleneck.py::plan, which owns the launch geometry; the launch
//    refuses a patch whose haloed ring the warps' tiles do not cover). It
//    computes y1 on the (TH+2) x (TW+2) ring into shared memory, y2 on the
//    patch into shared memory, then the expand, the residual and the output
//    straight to device memory. The TPU kernel's slab of whole image rows
//    and its VMEM-resident weights do not fit the 227 KB of a Hopper block.
//  * Each product is a GEMM of all of its rows (ring positions or patch
//    pixels, padded with zero rows to a multiple of 16) by a K x N weight
//    matrix, one pass per BN output columns. 8 warps: 2 along the rows (each
//    takes every other m16 tile, up to MI of them) x 4 along the columns
//    (NJ n8 tiles each), so every staged weight chunk serves every row of
//    the block once: the bigger the patch, the fewer times the weights are
//    read from L2 over the image. Two tiles: 160 ring rows with 64-column
//    passes, whose registers (128 a thread) let two blocks share an SM, so
//    one block's barriers and copies overlap the other's products (M 64,
//    DETR stage 1); 128 ring rows with 128-column passes, one block an SM,
//    which halves the reduce's re-reads of x where M is 128 or more
//    (stages 2-4; 1 x 40 at M 512 is a ring of 126 rows).
//  * Products are mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32. A fragments
//    come by ldmatrix, weight fragments by ldmatrix.trans, loaded once a
//    chunk for all of the warp's tiles. Each tile's sum over a 64-deep chunk
//    is taken on the tensor cores into a fresh accumulator and added to the
//    running float32 sum by an FADD: the tensor cores' own float32 sums
//    truncate, and over a whole K (up to 4608) they drift further from the
//    exact sums, which moves more y1 and y2 values across bf16 rounding
//    points (PERF.md). The epilogues add the bias (loaded before
//    any store), apply the ReLU and write y1 and y2 to shared memory as
//    bf16.
//  * Every shared row (x chunk, weight chunk, y1, y2) is stored in 16-byte
//    chunks XOR-swizzled by row (chunk ^ row % 8), so the eight rows an
//    ldmatrix phase reads fall in eight different bank groups. y1 and y2
//    rows are padded to a multiple of 64 channels with zeros.
//  * The 3x3 is nine shifted products over the ring, with no im2col: a
//    lane's ldmatrix row address for patch pixel p at tap (ky, kx) is ring
//    row (p / TW + ky) * (TW + 2) + p % TW + kx.
//  * Chunks come through a ring of 3 shared-memory stages: two are in
//    flight while the tensor cores work on the third. A weight chunk (64
//    deep, BN wide) is one or two TMA boxes (cp.async.bulk.tensor) that one
//    thread starts and an mbarrier a stage reports; the TMA writes them in
//    the 128-byte swizzle the fragments are read with and zero-fills past
//    the weight's edges. Issued by every thread as 16-byte cp.async copies,
//    the weight chunks had kept each thread stalled in the issue for 21-38%
//    of a block (PERF.md). For the 1x1 reduce, the matching 64 channels of
//    the ring's x rows still come by 16-byte cp.async copies: ring rows
//    outside the image, and channels past C, are zero-filled by cp.async's
//    src-size, so no stale value reaches a product; the reduce's epilogue
//    then writes y1 = 0 at every ring row outside the image (SAME padding),
//    and 0 in the padding channels.
//  * The x staging of the 1x1 reduce shares its shared memory with y2, which
//    only exists after it.
//  * The expand's epilogue regroups each quad's accumulators by shuffles so
//    that a thread reads the residual and writes the output as whole 16-byte
//    segments, all of a pass's residual loads before its first store.
//
// float32 (bottleneck_kernel, CUDA cores). The same patch and ring; each
// product in ROWS x NT output tiles (ROWS * NT = 4096, 16 outputs a thread in
// a 4 x 4 register tile), A and the weights staged as float in 32-deep K
// chunks, float32 FMAs. TF32 tensor cores would break its 1e-4 tolerance, and
// it already beats the float32 cuDNN chain (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

// The phase counters of the profile build (nvcc -DK3_PHASE_PROFILE, made by
// bottleneck_phase_profile.py): thread 0 of every bf16 block adds its clock
// cycles in each product (0 the reduce, 1 the 3x3, 2 the expand) and phase of
// the pipeline (0 waiting for the copies and the barrier, 1 issuing the next
// copies, 2 the products, 3 the epilogue) to g_phase_cycles[4 * product +
// phase]; [15] counts the blocks. Without the macro PhaseClock does nothing.
#ifdef K3_PHASE_PROFILE
__device__ unsigned long long g_phase_cycles[16];
struct PhaseClock {
  long long t = 0, cyc[4] = {0, 0, 0, 0};
  __device__ void start() { t = clock64(); }
  __device__ void mark(int phase) {
    const long long now = clock64();
    cyc[phase] += now - t;
    t = now;
  }
  __device__ void add(int product) const {
    if (threadIdx.x != 0) return;
    for (int k = 0; k < 4; ++k) atomicAdd(&g_phase_cycles[4 * product + k], (unsigned long long)cyc[k]);
    if (product == 2) atomicAdd(&g_phase_cycles[15], 1ull);
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void add(int) const {}
};
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // K chunk staged per step
constexpr int kBlockSmem = 232448;

// ======================================================= float32 (CUDA cores)
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// Four consecutive T as floats, and back (residual and output).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// ===================================================== bf16 (tensor cores)
using bf16 = __nv_bfloat16;
constexpr int kWarpsM = 2;            // warps along the rows of a product
constexpr int kWarpsN = 4;            // warps along its columns
constexpr int kMmaThreads = 32 * kWarpsM * kWarpsN;
constexpr int kIssuer = kMmaThreads - 32;  // the thread that starts the weight copies
constexpr int kChunk = 64;            // K chunk: 64 bf16, one 128-byte shared row
constexpr int kStages = 3;            // K chunks in the ring of copies
constexpr int kChanAlign = 64;        // y1 and y2 rows padded to a multiple of 64 channels

constexpr int kAlign = 1024;          // the TMA's 128-byte swizzle wants 1024-byte aligned boxes

// One block's shared memory, in bytes (kernels/bottleneck.py::smem_bytes
// mirrors it), from a base rounded up to kAlign: y1 on the ring; then y2,
// which shares its bytes with the reduce's x staging (kStages chunks of the
// ring's rows); then the weight staging (kStages chunks of kChunk x BN, in
// 64-column boxes of kChunk x 128 bytes); then one mbarrier a stage.
// `total` counts the kAlign bytes the base may need.
struct MmaLayout {
  int R, P;       // ring positions, patch pixels
  int Rp, Pp;     // both padded to a multiple of 16 rows
  int Mp;         // channels of a y1 / y2 row
  size_t y2;      // offset of y2 and of the x staging
  size_t w;       // offset of the weight staging
  size_t bar;     // offset of the stages' mbarriers
  size_t total;
};

__host__ __device__ inline MmaLayout mma_layout(int TH, int TW, int M, int BN) {
  MmaLayout L;
  L.R = (TH + 2) * (TW + 2);
  L.P = TH * TW;
  L.Rp = (L.R + 15) / 16 * 16;
  L.Pp = (L.P + 15) / 16 * 16;
  L.Mp = (M + kChanAlign - 1) / kChanAlign * kChanAlign;
  const size_t ring = (size_t)L.Rp * L.Mp * 2, y2 = (size_t)L.Pp * L.Mp * 2;
  const size_t xs = (size_t)kStages * L.Rp * kChunk * 2;
  L.y2 = ring;
  L.w = ring + (y2 > xs ? y2 : xs);
  L.bar = L.w + (size_t)kStages * kChunk * BN * 2;
  L.total = L.bar + 64 + kAlign;
  return L;
}

// Byte offset of 16-byte chunk c of row r in rows of row_bytes (a multiple
// of 128), XOR-swizzled by row.
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// mbarriers and TMA loads (the weight chunks' copies).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Wait for phase `parity` of the barrier to complete. A copy that never
// lands traps the kernel (a launch error) after 2^24 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1ll << 24)) __trap();
  }
}
// Box (c0, c1[, c2]) of a tensor map (innermost coordinate first) into
// shared memory at dst; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// MI: m16 tiles a warp holds (the block covers 32 * MI rows); NJ: n8 tiles a
// warp holds (a pass covers BN = 32 * NJ columns); MINB: blocks an SM the
// registers are budgeted for. The thread that starts the weight copies
// (kIssuer) is in a warp of the second row, which holds a tile fewer when
// the tiles are odd: the issue stalls for hundreds of cycles a chunk.
template <int MI, int NJ, int MINB>
__global__ void __launch_bounds__(kMmaThreads, MINB)
bottleneck_mma(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap tw1, const float* __restrict__ b1,
               const __grid_constant__ CUtensorMap tw2, const float* __restrict__ b2,
               const __grid_constant__ CUtensorMap tw3, const float* __restrict__ b3, bf16* __restrict__ out,
               int H, int W, int C, int M, int TH, int TW) {
  static_assert(NJ % 2 == 0, "weight fragments come two n8 tiles to an ldmatrix");
  constexpr int BN = kWarpsN * 8 * NJ;
  constexpr int kWRow = BN * 2;        // bytes of a staged weight row
  constexpr int kXRow = kChunk * 2;    // bytes of a staged x row
  extern __shared__ __align__(128) uint8_t smem[];
  const MmaLayout L = mma_layout(TH, TW, M, BN);
  const uint32_t s_ring = (smem_u32(smem) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t s_y2 = s_ring + (uint32_t)L.y2;  // also the x staging of the reduce
  const uint32_t s_w = s_ring + (uint32_t)L.w;
  const uint32_t s_bar = s_ring + (uint32_t)L.bar;
  const int yrow = L.Mp * 2;  // bytes of a y1 / y2 row
  const int TW2 = TW + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane >> 2, tq = lane & 3;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const bf16* xb = x + (size_t)blockIdx.z * H * W * C;
  bf16* ob = out + (size_t)blockIdx.z * H * W * C;

  // Image pixel (h * W + w) of ring position r, or -1 outside the image.
  auto ring_pixel = [&](int r) {
    const int h = h0 - 1 + r / TW2, w = w0 - 1 + r % TW2;
    return (r < L.R && h >= 0 && h < H && w >= 0 && w < W) ? h * W + w : -1;
  };

  float acc[MI][NJ][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(s_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t phases = 0;  // bit s: the parity of stage s's next completion

  // Start the TMA copy of rows [k0, k0 + kChunk) x columns [n0, n0 + BN) of
  // a weight (of tap `tap` for W2's 3-D map) into stage slot: one thread
  // issues BN / 64 boxes of kChunk x 64 values, which the TMA swizzles by
  // 128 bytes (chunk ^ row % 8, as w_off reads them) and zero-fills past
  // the weight's edges. The fence orders the slot's earlier reads before
  // the copy's writes.
  auto issue_w = [&](int slot, const CUtensorMap* map, int tap, int k0, int n0) {
    if (tid != kIssuer) return;
    const uint32_t bar = s_bar + 8 * slot, base = s_w + slot * kChunk * kWRow;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, kChunk * kWRow);
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) {
      if (tap < 0)
        tma_load(base + h * kChunk * 128, map, n0 + 64 * h, k0, bar);
      else
        tma_load(base + h * kChunk * 128, map, n0 + 64 * h, k0, tap, bar);
    }
  };
  // Byte offset in a weight slot of 16-byte chunk c (8 columns) of row k.
  auto w_off = [&](int k, int c) { return (uint32_t)((c >> 3) * kChunk * 128) + swz(k, c & 7, 128); };

  // acc += A * (the weight chunk in stage slot) over kChunk K values: A's
  // rows are the `tiles` m16 tiles at a_base (rows of a_bytes), the lane's
  // ldmatrix row of this warp's tile mi is a_row(mi), and the chunk starts
  // at 16-byte chunk a_c0 of the row. The weight fragments of the whole
  // chunk are loaded once and serve every tile of the warp. The tensor
  // cores' float32 sums truncate: each tile's sum over the chunk goes into a
  // fresh accumulator that is added to acc in IEEE float32, which keeps acc
  // about as close to the exact sums as the plain version's FMAs keep theirs
  // (PERF.md).
  auto mma_chunk = [&](int slot, int tiles, uint32_t a_base, int a_bytes, int a_c0, auto a_row) {
    constexpr int kSteps = kChunk / 16;
    const uint32_t wb = s_w + slot * kChunk * kWRow;
    uint32_t b[kSteps][NJ][2];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t r[4];
        ldsm_x4_trans(wb + w_off(16 * ks + (lane & 15), wn * NJ + j + (lane >> 4)), r);
        b[ks][j][0] = r[0];
        b[ks][j][1] = r[1];
        b[ks][j + 1][0] = r[2];
        b[ks][j + 1][1] = r[3];
      }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (wm + kWarpsM * mi >= tiles) continue;
      const int row = a_row(mi);
      float part[NJ][4] = {};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t a[4];
        ldsm_x4(a_base + swz(row, a_c0 + 2 * ks + (lane >> 4), a_bytes), a);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(part[j], a, b[ks][j][0], b[ks][j][1]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[j][e];
    }
  };

  // One product: `passes` column passes of `chunks` K chunks each, through
  // the kStages-slot ring (two chunks in flight while one is multiplied).
  // issue(i, slot) starts chunk i's copies, compute(i, slot) multiplies it,
  // epilogue(pass) stores a finished pass.
  int product = 0;  // which product run is in, for the profile build's counters
  auto run = [&](int passes, int chunks, auto issue, auto compute, auto epilogue) {
    const int total = passes * chunks;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < total) issue(i, i);
      cp_async_commit();
    }
    zero_acc();
    PhaseClock clock;
    clock.start();
    for (int i = 0; i < total; ++i) {
      const int slot = i % kStages;
      cp_async_wait<kStages - 2>();  // chunk i's x rows (the reduce) have landed
      mbar_wait(s_bar + 8 * slot, (phases >> slot) & 1u);  // ... and its weights
      phases ^= 1u << slot;
      __syncthreads();               // ... for every thread; chunk i - 1's slot is free
      clock.mark(0);
      const int next = i + kStages - 1;
      if (next < total) issue(next, next % kStages);
      cp_async_commit();
      clock.mark(1);
      compute(i, slot);
      clock.mark(2);
      if (i % chunks == chunks - 1) {
        epilogue(i / chunks);
        zero_acc();
      }
      clock.mark(3);
    }
    clock.add(product++);
    cp_async_wait<0>();
    __syncthreads();  // the product's shared output is complete
  };

  // Each thread's (row, column) pairs of a pass: fn(mi, j, h, r, n) for the
  // accumulator acc[mi][j][2h], acc[mi][j][2h + 1] of row r = 16 t + g + 8 h
  // and columns n, n + 1.
  auto for_each_out = [&](int tiles, int pass, auto fn) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int t = wm + kWarpsM * mi;
      if (t >= tiles) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = pass * BN + (wn * NJ + j) * 8 + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) fn(mi, j, h, 16 * t + g + 8 * h, n);
      }
    }
  };
  auto store_y = [&](uint32_t base, int r, int n, float v0, float v1) {
    const uint32_t v = pack_bf16(v0, v1);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + swz(r, n >> 3, yrow) + (n & 7) * 2), "r"(v));
  };
  auto m16_row = [&](int mi) { return 16 * (wm + kWarpsM * mi) + (lane & 15); };
  // The bias pairs of this thread's columns n, n + 1 in a pass (0 past N),
  // loaded together before the epilogue stores anything.
  auto bias_pairs = [&](const float* b, int N, int pass, float2 (&bv)[NJ]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = pass * BN + (wn * NJ + j) * 8 + 2 * tq;
      bv[j] = n < N ? __ldg(reinterpret_cast<const float2*>(b + n)) : make_float2(0.f, 0.f);
    }
  };

  // ---- 1. y1 = relu(x . W1 + b1) on the ring; 0 outside the image and in
  //         the padding channels. Thread tid copies 16-byte chunk tid % 8 of
  //         ring rows tid / 8 + 32 i.
  const int xc = tid % 8;
  int xpix[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) xpix[i] = ring_pixel(tid / 8 + 32 * i);
  uint32_t ring_live = 0;  // bit 2 mi + h: the epilogue's ring row 16 t + g + 8 h is in the image
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ring_live |= (uint32_t)(ring_pixel(16 * (wm + kWarpsM * mi) + g + 8 * h) >= 0) << (2 * mi + h);
  const int cchunks = (C + kChunk - 1) / kChunk;
  run((L.Mp + BN - 1) / BN, cchunks,
      [&](int i, int slot) {
        const int n0 = i / cchunks * BN, k0 = i % cchunks * kChunk;
        const uint32_t base = s_y2 + slot * L.Rp * kXRow;
#pragma unroll
        for (int it = 0; it < MI; ++it) {
          const int r = tid / 8 + 32 * it;
          if (r < L.Rp) {
            const bool full = xpix[it] >= 0 && k0 + 8 * xc < C;
            cp_async16(base + swz(r, xc, kXRow), full ? xb + (size_t)xpix[it] * C + k0 + 8 * xc : xb, full);
          }
        }
        issue_w(slot, &tw1, -1, k0, n0);
      },
      [&](int, int slot) { mma_chunk(slot, L.Rp / 16, s_y2 + slot * L.Rp * kXRow, kXRow, 0, m16_row); },
      [&](int pass) {  // columns from M on have zero weights and bias: y1 = 0 there
        float2 bias[NJ];
        bias_pairs(b1, M, pass, bias);
        for_each_out(L.Rp / 16, pass, [&](int mi, int j, int h, int r, int n) {
          if (n >= L.Mp) return;
          const bool live = (ring_live >> (2 * mi + h)) & 1u;
          store_y(s_ring, r, n, live ? fmaxf(acc[mi][j][2 * h] + bias[j].x, 0.f) : 0.f,
                  live ? fmaxf(acc[mi][j][2 * h + 1] + bias[j].y, 0.f) : 0.f);
        });
      });

  // ---- 2. y2 = relu(conv3x3(y1) + b2) on the patch: nine shifted products
  //         over the ring. pbase[mi]: ring row of the lane's patch pixel at
  //         tap (0, 0); padding rows read ring row 0 and are never stored.
  int pbase[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = m16_row(mi);
    pbase[mi] = p < L.P ? (p / TW) * TW2 + p % TW : 0;
  }
  const int mchunks = L.Mp / kChunk;
  run((L.Mp + BN - 1) / BN, 9 * mchunks,
      [&](int i, int slot) {
        const int t = i % (9 * mchunks);
        issue_w(slot, &tw2, t / mchunks, t % mchunks * kChunk, i / (9 * mchunks) * BN);
      },
      [&](int i, int slot) {
        const int t = i % (9 * mchunks), tap = t / mchunks;
        const int shift = (tap / 3) * TW2 + tap % 3;
        mma_chunk(slot, L.Pp / 16, s_ring, yrow, t % mchunks * (kChunk / 8),
                  [&](int mi) { return pbase[mi] + shift; });
      },
      [&](int pass) {
        float2 bias[NJ];
        bias_pairs(b2, M, pass, bias);
        for_each_out(L.Pp / 16, pass, [&](int mi, int j, int h, int p, int n) {
          if (n < L.Mp)
            store_y(s_y2, p, n, fmaxf(acc[mi][j][2 * h] + bias[j].x, 0.f), fmaxf(acc[mi][j][2 * h + 1] + bias[j].y, 0.f));
        });
      });

  // ---- 3. out = relu((y2 . W3 + b3) + x) on the patch. The epilogue
  //         regroups each quad's accumulators (a pair of n8 tiles, rows g
  //         and g + 8: four 8-column segments) by three shuffles, so that
  //         each thread adds the residual to, and stores, one whole segment
  //         with 16-byte accesses. It loads all of a pass's residual
  //         segments before it stores any output, so the loads' latencies
  //         overlap (a load may not pass a store to out that could alias it).
  int opix[MI][2];  // image pixel of the epilogue's patch row 16 t + g + 8 h, or -1
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * (wm + kWarpsM * mi) + g + 8 * h, w = w0 + p % TW;
      opix[mi][h] = p < L.P && w < W ? (h0 + p / TW) * W + w : -1;
    }
  run((C + BN - 1) / BN, mchunks,
      [&](int i, int slot) { issue_w(slot, &tw3, -1, i % mchunks * kChunk, i / mchunks * BN); },
      [&](int i, int slot) { mma_chunk(slot, L.Pp / 16, s_y2, yrow, i % mchunks * (kChunk / 8), m16_row); },
      [&](int pass) {
        float2 bias[NJ];
        bias_pairs(b3, C, pass, bias);
        // This thread's segment of tile mi, tiles jj and jj + 1: row g + 8 h
        // (h = tq / 2), columns n .. n + 7; its image offset, or -1.
        auto segment = [&](int mi, int jj) -> long long {
          const int pix = tq >> 1 ? opix[mi][1] : opix[mi][0];
          const int n = pass * BN + (wn * NJ + jj + (tq & 1)) * 8;
          return pix < 0 || n >= C ? -1 : (long long)pix * C + n;
        };
        uint4 res[MI][NJ / 2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int jj = 0; jj < NJ; jj += 2) {
            const long long off = wm + kWarpsM * mi < L.Pp / 16 ? segment(mi, jj) : -1;
            res[mi][jj / 2] = off < 0 ? make_uint4(0u, 0u, 0u, 0u) : *reinterpret_cast<const uint4*>(xb + off);
          }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (wm + kWarpsM * mi >= L.Pp / 16) continue;
#pragma unroll
          for (int jj = 0; jj < NJ; jj += 2) {
            // Segment s = h * 2 + (j - jj) of the quad: row g + 8 h, n8 tile j.
            // In round r this thread gathers columns 2k, 2k + 1 (k = tq ^ r)
            // of its segment tq from quad thread k, which sends its pair of
            // segment tq ^ r.
            float v[8] = {};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int s = tq ^ r;
              float a0 = 0.f, a1 = 0.f;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int h = c >> 1, j = jj + (c & 1);
                a0 = s == c ? acc[mi][j][2 * h] + bias[j].x : a0;
                a1 = s == c ? acc[mi][j][2 * h + 1] + bias[j].y : a1;
              }
              if (r) {
                a0 = __shfl_xor_sync(0xffffffffu, a0, r);
                a1 = __shfl_xor_sync(0xffffffffu, a1, r);
              }
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                v[2 * k] = k == (tq ^ r) ? a0 : v[2 * k];
                v[2 * k + 1] = k == (tq ^ r) ? a1 : v[2 * k + 1];
              }
            }
            const long long off = segment(mi, jj);
            if (off < 0) continue;
            const uint4 r4 = res[mi][jj / 2];
            const uint32_t rw[4] = {r4.x, r4.y, r4.z, r4.w};
            uint32_t o[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              o[k] = pack_bf16(fmaxf(v[2 * k] + bf16_lo(rw[k]), 0.f), fmaxf(v[2 * k + 1] + bf16_hi(rw[k]), 0.f));
            *reinterpret_cast<uint4*>(ob + off) = make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
      });
}

// cuTensorMapEncodeTiled, looked up through the runtime (the library does
// not link libcuda), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The TMA map of `planes` row-major (rows, cols) bf16 matrices at w, read
// in boxes of kChunk rows x 64 columns (128 bytes, swizzled by 128 bytes)
// and zero past every edge.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols, int planes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, kChunk, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, planes > 1 ? 3 : 2, const_cast<void*>(w), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MI, int NJ, int MINB>
cudaError_t launch_mma(const void* x, const void* w1, const float* b1, const void* w2,
                       const float* b2, const void* w3, const float* b3, void* out, int B, int H,
                       int W, int C, int M, int TH, int TW, cudaStream_t stream) {
  constexpr int BN = kWarpsN * 8 * NJ;
  // The grid is ceil(W / TW) x H / TH x B patches; the warps' m16 tiles must
  // cover each patch's haloed ring.
  if (TH < 1 || TW < 1 || H % TH != 0 || C % 8 != 0 || M % 8 != 0 ||
      (long long)(TH + 2) * (TW + 2) > 32LL * MI)
    return cudaErrorInvalidValue;
  const MmaLayout L = mma_layout(TH, TW, M, BN);
  if (L.total > (size_t)kBlockSmem) return cudaErrorInvalidValue;
  CUtensorMap tw1, tw2, tw3;  // W1 (C, M), W2 9 x (M, M), W3 (M, C)
  if (!weight_map(&tw1, w1, C, M, 1) || !weight_map(&tw2, w2, M, M, 9) || !weight_map(&tw3, w3, M, C, 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_mma<MI, NJ, MINB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, H / TH, B);
  bottleneck_mma<MI, NJ, MINB><<<grid, kMmaThreads, L.total, stream>>>(
      static_cast<const bf16*>(x), tw1, b1, tw2, b2, tw3, b3, static_cast<bf16*>(out), H, W, C, M, TH, TW);
  return cudaGetLastError();
}

// Every K3 instantiation, for bottleneck_kernel_attributes.
struct Entry {
  const char* name;
  const void* fn;
};
const Entry kKernels[] = {
    {"bottleneck_mma<bf16,5,2,2>", (const void*)bottleneck_mma<5, 2, 2>},
    {"bottleneck_mma<bf16,4,4,1>", (const void*)bottleneck_mma<4, 4, 1>},
    {"bottleneck_kernel<float,64>", (const void*)bottleneck_kernel<float, 64>},
    {"bottleneck_kernel<float,32>", (const void*)bottleneck_kernel<float, 32>},
    {"bottleneck_kernel<float,16>", (const void*)bottleneck_kernel<float, 16>},
};

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// tile_h x tile_w pixels per block, as kernels/bottleneck.py::plan gives
// them. rows: for float32 the GEMM tile's row count (64, 32 or 16, with
// tile_h * tile_w <= rows); for bf16 the ring rows the tiles cover (160 or
// 128, with (tile_h + 2) * (tile_w + 2) <= rows). stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 = success); a geometry the tiles
// do not cover, or whose block does not fit shared memory, is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int fused_bottleneck(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* w3, const void* b3,
                                void* out, int B, int H, int W, int C, int M, int tile_h,
                                int tile_w, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  cudaError_t err = cudaErrorInvalidValue;
  // The bf16 tiles, by the ring rows they cover (kernels/bottleneck.py::
  // MMA_TILES): 160 = 2 x 5 m16 tiles with 64-column passes, registers for
  // two blocks an SM; 128 = 2 x 4 m16 tiles with 128-column passes, one
  // block an SM.
  if (dtype == 0) {
    err = launch_rows<float>(rows, x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, C, M, tile_h,
                             tile_w, s);
  } else if (dtype == 1 && rows == 160) {
    err = launch_mma<5, 2, 2>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, C, M, tile_h, tile_w, s);
  } else if (dtype == 1 && rows == 128) {
    err = launch_mma<4, 4, 1>(x, w1, fb1, w2, fb2, w3, fb3, out, B, H, W, C, M, tile_h, tile_w, s);
  }
  return (int)err;
}

// The dynamic shared bytes fused_bottleneck requests for a block at these
// tiles (kernels/bottleneck.py::smem_bytes must give the same), or -1 for
// tiles it does not have.
extern "C" long long bottleneck_smem_bytes(int dtype, int rows, int tile_h, int tile_w, int M) {
  if (dtype == 0 && (rows == 64 || rows == 32 || rows == 16)) {
    const size_t item = sizeof(float);
    return (long long)(rows == 64   ? smem_bytes<64>(tile_h, tile_w, M, item)
                       : rows == 32 ? smem_bytes<32>(tile_h, tile_w, M, item)
                                    : smem_bytes<16>(tile_h, tile_w, M, item));
  }
  if (dtype == 1 && rows == 160) return (long long)mma_layout(tile_h, tile_w, M, kWarpsN * 8 * 2).total;
  if (dtype == 1 && rows == 128) return (long long)mma_layout(tile_h, tile_w, M, kWarpsN * 8 * 4).total;
  return -1;
}

// The compiled resources of K3 instantiation i (0 <= i < count, in the order
// of kKernels): name, registers a thread, local (spill) bytes a thread,
// static shared bytes, most threads a block. Returns the cudaError_t, or
// cudaErrorInvalidValue past the end.
extern "C" int bottleneck_kernel_attributes(int i, const char** name, int* regs, int* local_bytes,
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

#ifdef K3_PHASE_PROFILE
// The profile build's 16 counters (g_phase_cycles) into out, then zeroed.
// Returns the cudaError_t.
extern "C" int phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
