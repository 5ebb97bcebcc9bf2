// Host staging of the I420 transfer routes: BGR -> I420 conversion (half
// the bytes of a BGR upload) and the XOR delta of consecutive I420 frames,
// one multithreaded pass over a batch. Byte-for-byte cv2.COLOR_BGR2YUV_I420
// (OpenCV's ITU-R BT.601 fixed-point constants, shift 20, chroma from the
// top-left pixel of each 2x2 block), so the device decode
// (ops/preprocessing.py::preprocess_frames_i420) sees the payload cv2 would
// give.
//
// The port's own copy of office_person_detection_vit_tpu/native/staging.cpp
// (the host half of ops/preprocessing.py bgr_to_i420 and i420_delta_encode
// there), under the same names. The detector converts and then deltas, so
// the JAX copy's fused convert-plus-delta entry is left out. A plain C++
// shared library, built at first use with g++ into _build/ and loaded with
// ctypes by ops/staging.py; separate from the nvcc library, so it builds on
// a machine without CUDA.
//
// Build (what ops/staging.py runs): g++ -O3 -shared -fPIC -pthread -std=c++17

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// OpenCV ITUR_BT_601 forward coefficients (modules/imgproc/src/color_yuv.simd.hpp).
constexpr int64_t CRY = 269484, CGY = 528482, CBY = 102760;
constexpr int64_t CRU = -155188, CGU = -305135, CBU = 460324;
constexpr int64_t CGV = -385875, CBV = -74448;
constexpr int SHIFT = 20;
constexpr int64_t HALF = int64_t(1) << (SHIFT - 1);
constexpr int64_t S16 = int64_t(16) << SHIFT;
constexpr int64_t S128 = int64_t(128) << SHIFT;

inline uint8_t clamp_u8(int64_t v) {
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v));
}

// One frame: (H, W, 3) uint8 BGR -> (H*3/2, W) uint8 I420.
void frame_bgr_to_i420(const uint8_t* bgr, int64_t H, int64_t W, uint8_t* out) {
  uint8_t* yp = out;
  uint8_t* up = out + H * W;
  uint8_t* vp = up + (H / 2) * (W / 2);
  for (int64_t i = 0; i < H; ++i) {
    const uint8_t* row = bgr + i * W * 3;
    uint8_t* yrow = yp + i * W;
    const bool chroma_row = (i & 1) == 0;
    uint8_t* urow = up + (i / 2) * (W / 2);
    uint8_t* vrow = vp + (i / 2) * (W / 2);
    for (int64_t j = 0; j < W; ++j) {
      const int64_t b = row[3 * j], g = row[3 * j + 1], r = row[3 * j + 2];
      yrow[j] = clamp_u8((CRY * r + CGY * g + CBY * b + HALF + S16) >> SHIFT);
      if (chroma_row && (j & 1) == 0) {
        urow[j / 2] = clamp_u8((CRU * r + CGU * g + CBU * b + HALF + S128) >> SHIFT);
        vrow[j / 2] = clamp_u8((CBU * r + CGV * g + CBV * b + HALF + S128) >> SHIFT);
      }
    }
  }
}

void parallel_frames(int64_t F, int threads, void (*body)(int64_t, void*),
                     void* ctx) {
  if (threads <= 1 || F <= 1) {
    for (int64_t f = 0; f < F; ++f) body(f, ctx);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t f = next.fetch_add(1);
      if (f >= F) return;
      body(f, ctx);
    }
  };
  std::vector<std::thread> pool;
  const int n = threads > F ? static_cast<int>(F) : threads;
  pool.reserve(n);
  for (int t = 0; t < n; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

struct ConvertCtx {
  const uint8_t* bgr;
  uint8_t* out;
  int64_t H, W;
};

void convert_body(int64_t f, void* p) {
  auto* c = static_cast<ConvertCtx*>(p);
  frame_bgr_to_i420(c->bgr + f * c->H * c->W * 3, c->H, c->W,
                    c->out + f * (c->H * 3 / 2) * c->W);
}

struct XorCtx {
  uint8_t* out;          // (F, plane) freshly converted i420
  const uint8_t* prev;   // (plane) seed frame
  int64_t plane;
};

// delta[f] = i420[f] ^ i420[f-1] (prev seeds f=0), in place. It reads the
// unmodified predecessor, so the caller sweeps the frames high to low.
void xor_chunk(int64_t f, void* p) {
  auto* c = static_cast<XorCtx*>(p);
  const uint8_t* src = f == 0 ? c->prev : c->out + (f - 1) * c->plane;
  uint8_t* dst = c->out + f * c->plane;
  for (int64_t i = 0; i < c->plane; ++i) dst[i] ^= src[i];
}

}  // namespace

extern "C" {

// (F, H, W, 3) uint8 BGR -> (F, H*3/2, W) uint8 I420. H%2==0, W%2==0.
// Returns 0 on success.
int opdv_bgr_to_i420(const uint8_t* bgr, int64_t F, int64_t H, int64_t W,
                     uint8_t* out, int threads) {
  if (F < 0 || H <= 0 || W <= 0 || (H % 2) || (W % 2)) return 1;
  ConvertCtx ctx{bgr, out, H, W};
  parallel_frames(F, threads, convert_body, &ctx);
  return 0;
}

// In-place XOR delta over already-I420 planes: planes[f] ^= planes[f-1],
// planes[0] ^= prev (high-to-low sweep preserves predecessors).
int opdv_i420_delta(uint8_t* planes, const uint8_t* prev, int64_t F,
                    int64_t plane_bytes) {
  if (F < 0 || plane_bytes <= 0) return 1;
  for (int64_t f = F - 1; f >= 0; --f) {
    XorCtx ctx{planes, prev, plane_bytes};
    xor_chunk(f, &ctx);
  }
  return 0;
}

}  // extern "C"
