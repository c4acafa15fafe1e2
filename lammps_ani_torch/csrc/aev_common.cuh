// Device helpers shared by the AEV kernels of aev_roll.cu and aev_asn.cu:
// math overloads for float and double, the roll-bin window geometry
// (neighbor bin, wrap shift, shifted candidate position), the angular
// pair-term body, which the angular kernels evaluate per slot pair, and
// the fixed-order sum of the backwards' per-block box-cotangent partials
// (dh_reduce_kernel).
//
// Included by each .cu file (each builds into its own library); everything
// here lives in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kNA = 4;      // angular radial shifts (ANI: 4)
constexpr int kNZ = 8;      // angular angle sections (ANI: 8)
constexpr int kNAZ = kNA * kNZ;
constexpr int kMaxS = 8;    // species
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }

struct Grid {
  int nx, ny, nz, cap;
};

// Neighbor bin of bin `cell` at offset (ox, oy, oz), and its wrap shift.
__device__ __forceinline__ int neighbor_bin(const Grid& g, int cell, int ox,
                                            int oy, int oz, int& sx, int& sy,
                                            int& sz) {
  const int iz = cell % g.nz;
  const int iy = (cell / g.nz) % g.ny;
  const int ix = cell / (g.ny * g.nz);
  int jx = ix + ox, jy = iy + oy, jz = iz + oz;
  sx = jx < 0 ? -1 : (jx >= g.nx ? 1 : 0);
  sy = jy < 0 ? -1 : (jy >= g.ny ? 1 : 0);
  sz = jz < 0 ? -1 : (jz >= g.nz ? 1 : 0);
  jx -= sx * g.nx;
  jy -= sy * g.ny;
  jz -= sz * g.nz;
  return (jx * g.ny + jy) * g.nz + jz;
}

// Window offset o of a shell-`shell` window, x outermost.
__device__ __forceinline__ void offset_of(int o, int shell, int& ox, int& oy,
                                          int& oz) {
  const int ns = 2 * shell + 1;
  ox = o / (ns * ns) - shell;
  oy = (o / ns) % ns - shell;
  oz = o % ns - shell;
}

// Candidate position: owner + sx h0 + sy h1 + sz h2, added in that order
// (the order of the TPU halo copies, so f64 results agree bit for bit).
template <typename T>
__device__ __forceinline__ void candidate_pos(const T* pos, int slot,
                                              const T* h, int sx, int sy,
                                              int sz, T& px, T& py, T& pz) {
  px = pos[slot * 3 + 0];
  py = pos[slot * 3 + 1];
  pz = pos[slot * 3 + 2];
  if (sx) { px += sx * h[0]; py += sx * h[1]; pz += sx * h[2]; }
  if (sy) { px += sy * h[3]; py += sy * h[4]; pz += sy * h[5]; }
  if (sz) { px += sz * h[6]; py += sz * h[7]; pz += sz * h[8]; }
}

template <typename T>
__device__ __forceinline__ T pair_dist(T dx, T dy, T dz) {
  const T d2 = dx * dx + dy * dy + dz * dz;
  return m_sqrt(d2 > T(1e-12) ? d2 : T(1e-12));
}

// Angular constants (single eta_a and zeta, uniform shf_a grid).
template <typename T>
struct AngConsts {
  T rca, eta, zeta, mu0, delta, tiny;
  T cos_m[kNZ], sin_m[kNZ];
  int zeta_int;  // zeta as an integer in [1, 128], else 0
};

template <typename T>
__device__ __forceinline__ T zeta_pow(T base, const AngConsts<T>& p) {
  if (p.zeta_int <= 0) return m_exp(p.zeta * m_log(base));
  T acc = T(1), sq = base;
  bool first = true;
  for (int n = p.zeta_int; n; n >>= 1) {
    if (n & 1) {
      acc = first ? sq : acc * sq;
      first = false;
    }
    if (n > 1) sq = sq * sq;
  }
  return acc;
}

// Geometry of one slot pair: (c95, sv, fc12, x2, e_j, base_m, f1_m).
template <typename T>
struct PairTerms {
  T c95, sv, fc12, x2, dsum;
  T e[kNA], base[kNZ], f1[kNZ];
};

// The pair-term body (aev_pallas.py `_pair_terms_core`) up to the powers:
// every term but f1_m, from the unit vectors u1, u2, distances d1, d2 and
// cutoff values fc1, fc2 of the two arms.
template <typename T>
__device__ __forceinline__ void pair_terms_geom(
    const AngConsts<T>& p, T u1x, T u1y, T u1z, T u2x, T u2y, T u2z, T d1,
    T d2, T fc1, T fc2, PairTerms<T>& t) {
  T cq = u1x * u2x + u1y * u2y + u1z * u2z;
  cq = cq < T(-1) ? T(-1) : (cq > T(1) ? T(1) : cq);
  t.c95 = T(0.95) * cq;
  t.sv = m_sqrt(T(1) - t.c95 * t.c95);
  t.fc12 = fc1 * fc2;
  t.dsum = d1 + d2;
  T rmean = T(0.5) * (d1 + d2);
  const T rmax = p.rca + T(1);
  t.x2 = (rmean < rmax ? rmean : rmax) - p.mu0;
#pragma unroll
  for (int j = 0; j < kNA; ++j) {
    const T xj = t.x2 - T(j) * p.delta;
    const T arg = -p.eta * (xj * xj);
    t.e[j] = arg > p.tiny ? m_exp(arg) : T(0);
  }
#pragma unroll
  for (int m = 0; m < kNZ; ++m)
    t.base[m] = T(0.5) * (T(1) + t.c95 * p.cos_m[m] + t.sv * p.sin_m[m]);
}

// The whole pair-term body: pair_terms_geom and f1_m = base_m^zeta.
template <typename T>
__device__ __forceinline__ void pair_terms_core(
    const AngConsts<T>& p, T u1x, T u1y, T u1z, T u2x, T u2y, T u2z, T d1,
    T d2, T fc1, T fc2, PairTerms<T>& t) {
  pair_terms_geom<T>(p, u1x, u1y, u1z, u2x, u2y, u2z, d1, d2, fc1, fc2, t);
#pragma unroll
  for (int m = 0; m < kNZ; ++m) t.f1[m] = zeta_pow(t.base[m], p);
}

constexpr int kRedThreads = 512;
constexpr int kRedRows = 4;  // partial rows a thread loads at once

// dh[i] = sum over rows r of dh_part[r, i], in a fixed order, by one block
// in one coalesced pass: thread t adds rows t, t + kRedThreads, ... into
// nine running sums (kRedRows rows' loads in flight), the warps add their
// threads' sums by shuffles, and thread i < 9 adds the warps' sums in warp
// order. Two calls on the same partials agree bit for bit.
template <typename T>
__global__ void __launch_bounds__(kRedThreads) dh_reduce_kernel(
    const T* __restrict__ dh_part, int n, T* __restrict__ dh) {
  __shared__ T red[kRedThreads / 32][9];
  T acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = T(0);
  for (int r0 = threadIdx.x; r0 < n; r0 += kRedRows * kRedThreads) {
    T v[kRedRows][9];
#pragma unroll
    for (int b = 0; b < kRedRows; ++b) {
      const int r = r0 + b * kRedThreads;
#pragma unroll
      for (int i = 0; i < 9; ++i)
        v[b][i] = r < n ? dh_part[(size_t)r * 9 + i] : T(0);
    }
#pragma unroll
    for (int b = 0; b < kRedRows; ++b)
#pragma unroll
      for (int i = 0; i < 9; ++i) acc[i] += v[b][i];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    T s = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    T s = T(0);
    for (int w = 0; w < kRedThreads / 32; ++w) s += red[w][threadIdx.x];
    dh[threadIdx.x] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
