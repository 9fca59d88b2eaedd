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
// The shot step's epilogue (fd3d_step_tapered below) is a second
// instantiation of the same body (fd3d_body<T, true>), launched as
// fd3d_kernel_tapered.  It finishes the carry of seismic/model.py::run_shot
// in the same launch:
//
//   taper   = (mz[z] * my[y]) * mx[x]          the sponge, from 1-D ramps
//   prev    = T(u_prev * taper)                the next u_prev, formed on load
//   v       = T(2 u - prev + c2dt2 * lap / dx^2)
//   v       = T(v + amp[0])                    at the source cell only
//   out     = T(v * taper)
//
// T() rounds to the stored type (a no-op in fp32).  That is the unfused
// sequence's order and rounding, op for op: the plain step, the source add_,
// u_next.mul_(mask) and u.mul_(mask), each of which stores a T.  The 3-D mask
// PyTorch forms as (mz * my) * mx is the same fp32 product, so the result is
// bit for bit the unfused one.  u_prev is read only at the thread's own cell,
// so the multiply that made the next u_prev moves from the end of one step
// to the load in the next: the step still reads u, u_prev and c2dt2 once and
// writes out once (16 B a cell in fp32); the ramps (nz + ny + nx floats)
// stay in cache.  amp is read from device memory, so the caller passes a
// view of its wavelet without a host sync.  The epilogue's few more live
// values would take the body from 32 to 37 registers and a full SM from 8
// blocks of 256 threads to 6 (on an H100, 1.34 ms a launch at 187 x 801 x
// 801 against the plain 1.14); its entry asks for 8 blocks an SM, which
// holds it at 32 registers without spills (1.15 ms).  The plain entry
// keeps its own launch bounds and code.
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

// v as the stored type would hold it.
template <typename T>
__device__ __forceinline__ float rounded(float v) { return v; }

template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue's operands: the sponge's three ramps (fp32, nz, ny and nx
// long), the source cell and its amplitude (one fp32 in device memory).
struct Epilogue {
  const float* mz;
  const float* my;
  const float* mx;
  const float* amp;
  int sz, sy, sx;
};

template <typename T, bool kEpilogue>
__device__ __forceinline__ void
fd3d_body(const T* __restrict__ u, const T* __restrict__ u_prev,
          const T* __restrict__ c2dt2, T* __restrict__ out,
          int nz, int ny, int nx, float dx2, const Epilogue& ep) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  float my_y = 0.f, mx_x = 0.f;
  if constexpr (kEpilogue) {
    my_y = __ldg(ep.my + y);
    mx_x = __ldg(ep.mx + x);
  }
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

    float prev = load(u_prev + i);
    float taper = 1.f;
    if constexpr (kEpilogue) {
      taper = __fmul_rn(__fmul_rn(__ldg(ep.mz + z), my_y), mx_x);
      prev = rounded<T>(__fmul_rn(prev, taper));
    }
    const float lead = __fsub_rn(__fmul_rn(2.f, w[HALO]), prev);
    float v = __fadd_rn(lead, __fmul_rn(load(c2dt2 + i), lap));
    if constexpr (kEpilogue) {
      v = rounded<T>(v);
      if (z == ep.sz && y == ep.sy && x == ep.sx) v = rounded<T>(__fadd_rn(v, __ldg(ep.amp)));
      v = __fmul_rn(v, taper);
    }
    store(out + i, v);

#pragma unroll
    for (int j = 0; j < 2 * HALO; ++j) w[j] = w[j + 1];
  }
}

template <typename T>
__global__ void __launch_bounds__(BX * BY)
fd3d_kernel(const T* __restrict__ u, const T* __restrict__ u_prev,
            const T* __restrict__ c2dt2, T* __restrict__ out,
            int nz, int ny, int nx, float dx2) {
  fd3d_body<T, false>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, Epilogue{});
}

template <typename T>
__global__ void __launch_bounds__(BX * BY, 8)
fd3d_kernel_tapered(const T* __restrict__ u, const T* __restrict__ u_prev,
                    const T* __restrict__ c2dt2, T* __restrict__ out,
                    int nz, int ny, int nx, float dx2, Epilogue ep) {
  fd3d_body<T, true>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, ep);
}

template <typename T, bool kEpilogue>
int launch(const void* u, const void* u_prev, const void* c2dt2, void* out,
           int nz, int ny, int nx, float dx2, Epilogue ep, cudaStream_t stream) {
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, (nz + ZC - 1) / ZC);
  const T* pu = static_cast<const T*>(u);
  const T* pp = static_cast<const T*>(u_prev);
  const T* pc = static_cast<const T*>(c2dt2);
  T* po = static_cast<T*>(out);
  if constexpr (kEpilogue)
    fd3d_kernel_tapered<T><<<grid, block, 0, stream>>>(pu, pp, pc, po, nz, ny, nx, dx2, ep);
  else
    fd3d_kernel<T><<<grid, block, 0, stream>>>(pu, pp, pc, po, nz, ny, nx, dx2);
  return (int)cudaGetLastError();
}

template <bool kEpilogue>
int dispatch(const void* u, const void* u_prev, const void* c2dt2, void* out,
             int nz, int ny, int nx, float dx2, Epilogue ep, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kEpilogue>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, ep, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kEpilogue>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, ep, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Launches on `stream`, does not synchronise and
// allocates nothing: the caller owns every buffer.
extern "C" int fd3d_step(const void* u, const void* u_prev, const void* c2dt2,
                         void* out, int nz, int ny, int nx, float dx2,
                         int dtype, void* stream) {
  return dispatch<false>(u, u_prev, c2dt2, out, nz, ny, nx, dx2, Epilogue{},
                         dtype, stream);
}

// One step with the shot's epilogue (see the top of this file): u_prev is
// taken times the taper, the source amplitude *amp is added at (sz, sy, sx)
// and out is stored times the taper.  mz, my, mx: fp32 ramps of nz, ny and
// nx; amp: one fp32.  The same contract as fd3d_step otherwise.
extern "C" int fd3d_step_tapered(const void* u, const void* u_prev,
                                 const void* c2dt2, void* out, int nz, int ny,
                                 int nx, float dx2, const float* mz,
                                 const float* my, const float* mx, int sz,
                                 int sy, int sx, const float* amp, int dtype,
                                 void* stream) {
  return dispatch<true>(u, u_prev, c2dt2, out, nz, ny, nx, dx2,
                        Epilogue{mz, my, mx, amp, sz, sy, sx}, dtype, stream);
}
