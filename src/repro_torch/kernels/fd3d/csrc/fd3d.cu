// Fused 3-D acoustic leapfrog step (paper Eq. 12) for Hopper (sm_90a).
//
//   out = 2 u - u_prev + c2dt2 * (3 C0 u + sum_{axis,k} COEF[k] (u[+k] + u[-k])) / dx^2
//
// a radius-4 star of 25 taps; neighbours outside the array count as zero.
//
// Replaces src/repro/kernels/fd3d/fd3d.py::fd3d_pallas (the TPU kernel).
//
// Bound on an H100: per cell it reads u, u_prev and c2dt2 once and writes
// out once, 16 B in fp32 (8 B in bf16), against about 42 flop (25 taps:
// 13 multiplies, 24 adds, plus the divide and the 4-op leapfrog).  That is
// ~2.6 flop/byte against the card's ~20 fp32 flop/byte (67 TFLOP/s over
// 3.35 TB/s), so the step is memory-bound: at 512^3 fp32 the least time is
// 2.15 GB / 3.35 TB/s ~ 0.64 ms.
//
// Design against that bound: every device-memory byte should be read once.
// One thread owns an (x, y) column over a run of ZC planes and keeps the
// 9-plane z window of u in registers, so each z step loads only the one new
// plane (u[z + 4]) for the z taps.  The x and y taps come through the
// read-only L1/L2 path: a warp spans 32 consecutive x, a block 8 rows of y,
// so neighbouring threads hit the same lines.  The boundary is masked loads:
// no padded copy of the wavefield is made (the Pallas wrapper's jnp.pad is a
// whole extra pass).  Any shape >= 1 on each axis is taken.
//
// The arithmetic is written with the _rn intrinsics, in the order of the
// plain version (ref.py: centre term, then axis z, y, x outer and k inner,
// then / dx^2), so the compiler does not contract it into FMAs and fp32
// results stay within an ulp or so of the plain PyTorch version.  bf16 is
// loaded as bf16, accumulated in fp32 and stored as bf16.
//
// Build (plain C interface, bound with ctypes; see ../fd3d.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libfd3d.so fd3d.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HALO = 4;
constexpr int BX = 32;  // threads along x: one warp, coalesced rows
constexpr int BY = 8;   // threads along y
constexpr int ZC = 16;  // planes a thread marches through

__device__ __forceinline__ float coef(int k) {
  // 8th-order central second-derivative weights (Fornberg), as float32.
  return k == 1 ? (float)(8.0 / 5.0)
       : k == 2 ? (float)(-1.0 / 5.0)
       : k == 3 ? (float)(8.0 / 315.0)
                : (float)(-1.0 / 560.0);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(BX * BY)
fd3d_kernel(const T* __restrict__ u, const T* __restrict__ u_prev,
            const T* __restrict__ c2dt2, T* __restrict__ out,
            int nz, int ny, int nx, float dx2) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const int z0 = blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, nz);
  const long long plane = (long long)ny * nx;
  const long long col = (long long)y * nx + x;
  const float centre_w = (float)(3.0 * (-205.0 / 72.0));

  // w[j] holds u at plane z - HALO + j of the current z.
  float w[2 * HALO + 1];
#pragma unroll
  for (int j = 0; j < 2 * HALO; ++j) {
    const int z = z0 - HALO + j;
    w[j] = (z >= 0 && z < nz) ? load(u + z * plane + col) : 0.f;
  }

  for (int z = z0; z < z1; ++z) {
    const int zh = z + HALO;
    w[2 * HALO] = zh < nz ? load(u + zh * plane + col) : 0.f;
    const long long i = z * plane + col;
    const T* uc = u + i;

    float lap = __fmul_rn(centre_w, w[HALO]);
#pragma unroll
    for (int k = 1; k <= HALO; ++k)
      lap = __fadd_rn(lap, __fmul_rn(coef(k), __fadd_rn(w[HALO - k], w[HALO + k])));
#pragma unroll
    for (int k = 1; k <= HALO; ++k) {
      const float lo = y - k >= 0 ? load(uc - (long long)k * nx) : 0.f;
      const float hi = y + k < ny ? load(uc + (long long)k * nx) : 0.f;
      lap = __fadd_rn(lap, __fmul_rn(coef(k), __fadd_rn(lo, hi)));
    }
#pragma unroll
    for (int k = 1; k <= HALO; ++k) {
      const float lo = x - k >= 0 ? load(uc - k) : 0.f;
      const float hi = x + k < nx ? load(uc + k) : 0.f;
      lap = __fadd_rn(lap, __fmul_rn(coef(k), __fadd_rn(lo, hi)));
    }
    lap = __fdiv_rn(lap, dx2);

    const float lead = __fsub_rn(__fmul_rn(2.f, w[HALO]), load(u_prev + i));
    store(out + i, __fadd_rn(lead, __fmul_rn(load(c2dt2 + i), lap)));

#pragma unroll
    for (int j = 0; j < 2 * HALO; ++j) w[j] = w[j + 1];
  }
}

template <typename T>
int launch(const void* u, const void* u_prev, const void* c2dt2, void* out,
           int nz, int ny, int nx, float dx2, cudaStream_t stream) {
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, (nz + ZC - 1) / ZC);
  fd3d_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(u_prev),
      static_cast<const T*>(c2dt2), static_cast<T*>(out), nz, ny, nx, dx2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Launches on `stream`, does not synchronise and
// allocates nothing: the caller owns every buffer.
extern "C" int fd3d_step(const void* u, const void* u_prev, const void* c2dt2,
                         void* out, int nz, int ny, int nx, float dx2,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, s);
  if (dtype == 1) return launch<__nv_bfloat16>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, s);
  return (int)cudaErrorInvalidValue;
}
