// Fused ordinary-kriging solve for NVIDIA Hopper, called through jax.ffi.
//
// One warp solves one k x k system (k <= 64). Lane l keeps rows l and
// l + 32 of the covariance in registers, padded to KP in {32, 48, 64} rows
// with inert identity rows. The kernel assembles the exponential covariance from
// the neighbours' unit-sphere coordinates with the exact asin, factors it
// with a right-looking Cholesky whose column broadcasts go through
// __shfl_sync, runs both triangular substitutions for the two right-hand
// sides (c0 and the ones vector) and applies the simple-to-ordinary kriging
// reduction. Nothing but the inputs and the (B, k) weights touches device
// memory. Semantics are those of kernels/cholesky.py::ok_krige_xla.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kEarthRadiusKm = 6371.0087714f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // four systems per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
ok_krige_kernel(const float* __restrict__ xyz,    // (B, k, 3)
                const float* __restrict__ dist,   // (B, k)
                const float* __restrict__ mask,   // (B, k), 1 = valid
                const float* __restrict__ vario,  // (B, 3)
                int64_t n_sys, int k, float jitter_frac, int min_neighbors,
                float* __restrict__ weights,      // (B, k)
                float* __restrict__ variance,     // (B,)
                float* __restrict__ ok) {         // (B,)
  constexpr int R = (KP + 31) / 32;  // register rows per lane
  const int lane = threadIdx.x & 31;
  const int64_t sys =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (sys >= n_sys) return;  // uniform across the warp

  const float nug = vario[3 * sys + 0];
  const float psill = vario[3 * sys + 1];
  const float rng = fmaxf(vario[3 * sys + 2], 1e-3f);
  const float sill = nug + psill;
  const float diag_add = nug + jitter_frac * sill;

  float px[R], py[R], pz[R], m[R], c0[R], b0[R], b1[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + 32 * j;
    const bool in = r < k;  // rows k..KP-1 are padding
    const int64_t e = sys * k + (in ? r : 0);
    px[j] = in ? xyz[3 * e + 0] : 0.f;
    py[j] = in ? xyz[3 * e + 1] : 0.f;
    pz[j] = in ? xyz[3 * e + 2] : 0.f;
    m[j] = (in && mask[e] > 0.5f) ? 1.f : 0.f;
    c0[j] = m[j] > 0.f ? psill * expf(-dist[e] / rng) : 0.f;
    b0[j] = c0[j];
    b1[j] = m[j];
  }

  // Covariance rows. Masked rows and columns fold to the identity.
  float a[R][KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    const int src = c & 31, jc = c >> 5;
    const float cx = __shfl_sync(kFull, px[jc], src);
    const float cy = __shfl_sync(kFull, py[jc], src);
    const float cz = __shfl_sync(kFull, pz[jc], src);
    const float cm = __shfl_sync(kFull, m[jc], src);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r >= KP) {  // lanes past the padded size hold no row
        a[j][c] = 0.f;
        continue;
      }
      const float dx = px[j] - cx, dy = py[j] - cy, dz = pz[j] - cz;
      const float half_chord =
          fminf(0.5f * sqrtf(dx * dx + dy * dy + dz * dz), 1.f);
      const float h = 2.f * kEarthRadiusKm * asinf(half_chord);
      float v = psill * expf(-h / rng);
      if (r == c) v += diag_add;
      v = (m[j] > 0.f && cm > 0.f) ? v : 0.f;
      if (r == c && m[j] == 0.f) v += 1.f;
      a[j][c] = v;
    }
  }

  // Right-looking Cholesky: column p of L lands in a[.][p] for rows >= p.
  // Rows above p keep the symmetric trailing Schur complement.
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const float lpp = sqrtf(__shfl_sync(kFull, a[p >> 5][p], p & 31));
    const float inv = 1.f / lpp;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r >= KP) continue;
      if (r > p) a[j][p] *= inv;
      else if (r == p) a[j][p] = lpp;
    }
#pragma unroll
    for (int c = p + 1; c < KP; ++c) {
      const float lcp = __shfl_sync(kFull, a[c >> 5][p], c & 31);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = lane + 32 * j;
        if (r > p && r < KP) a[j][c] -= a[j][p] * lcp;
      }
    }
  }

  // Forward substitution L z = b for both right-hand sides.
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int src = p & 31, jp = p >> 5;
    const float lpp = __shfl_sync(kFull, a[jp][p], src);
    const float z0 = __shfl_sync(kFull, b0[jp], src) / lpp;
    const float z1 = __shfl_sync(kFull, b1[jp], src) / lpp;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r == p) {
        b0[j] = z0;
        b1[j] = z1;
      } else if (r > p && r < KP) {
        b0[j] -= a[j][p] * z0;
        b1[j] -= a[j][p] * z1;
      }
    }
  }

  // Back substitution L^T x = z: row p of L^T is column p of L, spread
  // over the lanes below p, so each step is one warp reduction.
#pragma unroll
  for (int p = KP - 1; p >= 0; --p) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r > p && r < KP) {
        s0 += a[j][p] * b0[j];
        s1 += a[j][p] * b1[j];
      }
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    const int jp = p >> 5;
    if (lane == (p & 31)) {
      b0[jp] = (b0[jp] - s0) / a[jp][p];
      b1[jp] = (b1[jp] - s1) / a[jp][p];
    }
  }

  // Simple-to-ordinary kriging reduction (see kernels/cholesky.py).
  float sum_a = 0.f, sum_u = 0.f, n_valid = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    sum_a += b0[j] * m[j];
    sum_u += b1[j] * m[j];
    n_valid += m[j];
  }
  sum_a = warp_sum(sum_a);
  sum_u = warp_sum(sum_u);
  n_valid = warp_sum(n_valid);
  const bool solvable = n_valid >= static_cast<float>(min_neighbors) &&
                        sum_u > 1e-12f && isfinite(sum_u);
  const float t = (1.f - sum_a) / (solvable ? sum_u : 1.f);
  float lam_c0 = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + 32 * j;
    const float lam = m[j] > 0.f ? b0[j] + t * b1[j] : 0.f;
    if (r < k) weights[sys * k + r] = lam;
    lam_c0 += lam * c0[j];
  }
  lam_c0 = warp_sum(lam_c0);
  if (lane == 0) {
    variance[sys] = fmaxf(sill - lam_c0 + t, 0.f);
    ok[sys] = solvable ? 1.f : 0.f;
  }
}

ffi::Error OkKrigeImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> xyz,
                       ffi::Buffer<ffi::F32> dist, ffi::Buffer<ffi::F32> mask,
                       ffi::Buffer<ffi::F32> vario, float jitter_frac,
                       int32_t min_neighbors,
                       ffi::ResultBuffer<ffi::F32> weights,
                       ffi::ResultBuffer<ffi::F32> variance,
                       ffi::ResultBuffer<ffi::F32> ok) {
  const auto dims = dist.dimensions();
  if (dims.size() < 1) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "ok_krige: dist must be (..., k)");
  }
  const int64_t k = dims.back();
  if (k < 1 || k > 64) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "ok_krige: k must be in [1, 64]");
  }
  const int64_t n_sys = static_cast<int64_t>(dist.element_count()) / k;
  if (static_cast<int64_t>(xyz.element_count()) != 3 * n_sys * k ||
      static_cast<int64_t>(mask.element_count()) != n_sys * k ||
      static_cast<int64_t>(vario.element_count()) != 3 * n_sys) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "ok_krige: inconsistent operand sizes");
  }
  if (n_sys == 0) return ffi::Error::Success();
  const int64_t blocks = (n_sys * 32 + kThreads - 1) / kThreads;
  const int kk = static_cast<int>(k);
  // Pad k to the next of 32, 48, 64: the factorization is cubic in KP.
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        xyz.typed_data(), dist.typed_data(), mask.typed_data(),
        vario.typed_data(), n_sys, kk, jitter_frac, min_neighbors,
        weights->typed_data(), variance->typed_data(), ok->typed_data());
  };
  if (k <= 32) {
    launch(ok_krige_kernel<32>);
  } else if (k <= 48) {
    launch(ok_krige_kernel<48>);
  } else {
    launch(ok_krige_kernel<64>);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal,
                      std::string("ok_krige launch: ") +
                          cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TopotpuOkKrige, OkKrigeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // xyz
                                  .Arg<ffi::Buffer<ffi::F32>>()  // dist
                                  .Arg<ffi::Buffer<ffi::F32>>()  // mask
                                  .Arg<ffi::Buffer<ffi::F32>>()  // vario
                                  .Attr<float>("jitter_frac")
                                  .Attr<int32_t>("min_neighbors")
                                  .Ret<ffi::Buffer<ffi::F32>>()  // weights
                                  .Ret<ffi::Buffer<ffi::F32>>()  // variance
                                  .Ret<ffi::Buffer<ffi::F32>>());  // ok
