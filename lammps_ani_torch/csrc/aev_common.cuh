// Device helpers shared by the AEV kernels of aev_roll.cu and aev_asn.cu:
// math overloads for float and double, the f32 Gaussian by ex2, the roll-bin
// window geometry (neighbor bin, wrap shift, shifted candidate position, the
// 27-bin window staged in shared memory), the angular pair-term body, which
// the angular kernels evaluate per slot pair, with its powers and its chain
// rule, the slot-pair enumeration of the pair stages, the warp
// reduce-scatter of 32 column sums, and the fixed-order sum of the
// backwards' per-block box-cotangent partials (dh_reduce_kernel).
//
// Included by each .cu file (each builds into its own library); everything
// here lives in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kNA = 4;      // angular radial shifts (ANI: 4)
constexpr int kNZ = 8;      // angular angle sections (ANI: 8)
constexpr int kNAZ = kNA * kNZ;
constexpr int kMaxS = 8;    // species
constexpr double kPi = 3.14159265358979323846;
constexpr unsigned kFull = 0xffffffffu;

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

// a / b; with FAST in f32, by the special-function unit's reciprocal
// (__fdividef, 2 ulp) instead of the IEEE division and its slow path.
template <bool FAST, typename T>
__device__ __forceinline__ T quot(T a, T b) {
  if constexpr (FAST && std::is_same<T, float>::value)
    return __fdividef(a, b);
  else
    return a / b;
}

// cos and sin of an argument in [0, pi]: in f32 the special-function
// unit's (__cosf, __sinf: absolute error 2^-21.4 on [-pi, pi]), which
// keeps cosf's and sinf's slow paths (and their local memory) out of a
// kernel; f64 as before.
__device__ __forceinline__ float cos_0pi(float x) { return __cosf(x); }
__device__ __forceinline__ double cos_0pi(double x) { return cos(x); }
__device__ __forceinline__ float sin_0pi(float x) { return __sinf(x); }
__device__ __forceinline__ double sin_0pi(double x) { return sin(x); }

// exp(-eta xk^2) from y = geta xk^2: f64 exp(y) (geta = -eta); f32 the
// special-function unit's 2^y (geta = -eta log2 e; ex2.approx, 2 ulp),
// one instruction where expf reduces its range first. The f32 argument
// rounds as expf's would but for geta's one rounding
// (tests/test_torch_step_arith.py); results below 2^-126 flush to 0.
__device__ __forceinline__ float gauss_of(float y) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y));
  return e;
}
__device__ __forceinline__ double gauss_of(double y) { return exp(y); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

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

// A window lane staged in shared memory: the shifted candidate position
// and the species (-1: an empty slot, or a species the kernel keeps no lane
// of). 16 bytes in f32 (one 16-byte load), 32 in f64.
template <typename T>
struct alignas(16) WinLane {
  T x, y, z;
  int sp;
};

// Stage the 27-bin window of bin `cell` in shared memory, win[w] for w <
// 27 cap (w = offset o * cap + slot b): the first 27 threads find each
// offset's bin and wrap shift once (tab: first grid slot, packed shift
// (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4), then the block stages the
// lanes. Positions by candidate_pos, so every distance to them has the
// bits it has from the grid; species outside the bit mask `keep` as -1.
// Every thread calls it; it ends with a barrier.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ pos,
                             const int* __restrict__ sp, const T* h,
                             const Grid& g, int cell, unsigned keep,
                             WinLane<T>* win, int2* tab) {
  if (threadIdx.x < 27) {
    int ox, oy, oz, sx, sy, sz;
    offset_of(threadIdx.x, 1, ox, oy, oz);
    const int base = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * g.cap;
    tab[threadIdx.x] = make_int2(base, (sx + 1) | (sy + 1) << 2 |
                                           (sz + 1) << 4);
  }
  __syncthreads();
  const int W = 27 * g.cap;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int o = w / g.cap;
    const int2 t = tab[o];
    const int q = t.x + (w - o * g.cap);
    const int s = sp[q];
    WinLane<T> v;
    candidate_pos(pos, q, h, (t.y & 3) - 1, (t.y >> 2 & 3) - 1,
                  (t.y >> 4 & 3) - 1, v.x, v.y, v.z);
    v.sp = (s >= 0 && (keep >> s & 1u)) ? s : -1;
    win[w] = v;
  }
  __syncthreads();
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
// cutoff values fc1, fc2 of the two arms. EX2 (f32 only; P carries geta =
// -eta log2 e and tiny2 = tiny log2 e): the four radial Gaussians by
// gauss_of(geta xj^2), kept where geta xj^2 > tiny2, instead of expf.
template <typename T, bool EX2 = false, typename P = AngConsts<T>>
__device__ __forceinline__ void pair_terms_geom(
    const P& p, T u1x, T u1y, T u1z, T u2x, T u2y, T u2z, T d1,
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
    if constexpr (EX2 && std::is_same<T, float>::value) {
      const T y = p.geta * (xj * xj);
      t.e[j] = y > p.tiny2 ? gauss_of(y) : T(0);
    } else {
      const T arg = -p.eta * (xj * xj);
      t.e[j] = arg > p.tiny ? m_exp(arg) : T(0);
    }
  }
#pragma unroll
  for (int m = 0; m < kNZ; ++m)
    t.base[m] = T(0.5) * (T(1) + t.c95 * p.cos_m[m] + t.sv * p.sin_m[m]);
}

// base^zeta of the 8 angle sections of one pair, f32, zeta not an
// integer: base^n 2^(f log2 base), n = floor(zeta), f = zeta - n. The
// fraction goes to the special-function unit (lg2, ex2), whose error f < 1
// scales instead of zeta. The integer part is square and multiply on b2 =
// base^2 = s + e, s the rounded square and e its exact error (an fma):
// base^n = r s + (k e) r with r = s^(k-1) base^(n & 1), k = n >> 1, so the
// rounding of b2, which the k-th power would multiply by k, does not enter.
// The formula is 4.2e-7 relative of base^zeta at worst over base in
// [0.025, 1] with exact lg2 and ex2 (tests/test_torch_packed_live.py);
// expf(zeta logf(base)) is 3.6e-6 there.
__device__ __forceinline__ void zeta_pow_split(const float (&b)[kNZ],
                                               float (&f1)[kNZ], int n,
                                               float frac) {
  const int k = n >> 1;
  float r[kNZ];
#pragma unroll
  for (int m = 0; m < kNZ; ++m) r[m] = (n & 1) ? b[m] : 1.0f;
  if (k > 0) {
    float s[kNZ], sq[kNZ];
#pragma unroll
    for (int m = 0; m < kNZ; ++m) {
      s[m] = b[m] * b[m];
      sq[m] = s[m];
    }
    // unrolled with an exit on the (uniform) bits left: as a plain loop,
    // ptxas spilled four registers of the enclosing pair loop
#pragma unroll
    for (int bit = 0; bit < 7; ++bit) {
      const int e = (k - 1) >> bit;
      if (e == 0) break;
      if (e & 1) {
#pragma unroll
        for (int m = 0; m < kNZ; ++m) r[m] *= sq[m];
      }
      if (e > 1) {
#pragma unroll
        for (int m = 0; m < kNZ; ++m) sq[m] *= sq[m];
      }
    }
#pragma unroll
    for (int m = 0; m < kNZ; ++m) {
      const float err = fmaf(b[m], b[m], -s[m]);
      r[m] = fmaf(float(k) * err, r[m], r[m] * s[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kNZ; ++m) f1[m] = r[m] * exp2f(frac * __log2f(b[m]));
}

// f1_m = base_m^zeta of pair terms from pair_terms_geom; P carries
// zeta_int, zeta_floor and zeta_frac (PackedParams, AngParams).
template <typename T, typename P>
__device__ __forceinline__ void pair_powers(const P& p, PairTerms<T>& pt) {
  if constexpr (std::is_same<T, float>::value) {
    if (p.zeta_int <= 0) {
      zeta_pow_split(pt.base, pt.f1, p.zeta_floor, p.zeta_frac);
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < kNZ; ++m) pt.f1[m] = zeta_pow(pt.base[m], p);
}

// ---------------------------------------------------------------------------
// Slot-pair helpers of the angular pair stages (packed and per-block)
// ---------------------------------------------------------------------------
constexpr int kCross = 0, kTri = 1;

// First pair of row j of an a x a strict upper triangle, row by row.
__device__ __forceinline__ int tri_start(int j, int a) {
  return j * (2 * a - j - 1) / 2;
}

// Slot pair (j, k) of pair index t: cross t = j a2 + k; tri, the upper
// triangle row by row.
template <int MODE>
__device__ __forceinline__ void block_pair(int t, int a1, int a2, int& j,
                                           int& k) {
  if (MODE == kCross) {
    j = t / a2;
    k = t - j * a2;
  } else {
    // counted from the end, the rows hold 1, 2, 3, ... pairs
    const int r = a1 * (a1 - 1) / 2 - 1 - t;
    int jr = (int)((sqrtf(8.0f * r + 1.0f) - 1.0f) * 0.5f);
    while ((jr + 1) * (jr + 2) / 2 <= r) ++jr;
    while (jr * (jr + 1) / 2 > r) --jr;
    j = a1 - 2 - jr;
    k = t - tri_start(j, a1) + j + 1;
  }
}

// The partner `o` of pair t adds its terms to one slot's five sums: dcos
// times the partner's unit vector, drmean / 2, dfc12 times its fc.
template <typename T>
__device__ __forceinline__ void add_partner(T (&g)[5], const T* pb, int q,
                                            int t, const T* so, int ao,
                                            int o) {
  const T dc = pb[t];
  g[0] += dc * so[o];
  g[1] += dc * so[ao + o];
  g[2] += dc * so[2 * ao + o];
  g[3] += pb[q + t];
  g[4] += pb[2 * q + t] * so[4 * ao + o];
}

// One pair's cotangent scalars for the column cotangents gb[32] (scale
// included): dcos, drmean (0 where the radial mean was clamped), dfc12.
// FAST_DIV: the f32 divisions by quot<true>.
template <typename T, bool FAST_DIV = false>
__device__ __forceinline__ void pair_cotangents(const AngConsts<T>& p,
                                                const PairTerms<T>& pt,
                                                const T (&gb)[kNAZ],
                                                T& dcos, T& drmean,
                                                T& dfc12) {
  T df2[kNA];
#pragma unroll
  for (int j = 0; j < kNA; ++j) df2[j] = T(0);
  dcos = T(0);
#pragma unroll
  for (int m = 0; m < kNZ; ++m) {
    T df1 = T(0);
#pragma unroll
    for (int j = 0; j < kNA; ++j) {
      const T gjm = gb[j * kNZ + m];
      df1 += gjm * (pt.fc12 * pt.e[j]);
      df2[j] += gjm * pt.f1[m];
    }
    const T dbase = df1 * quot<FAST_DIV>(p.zeta, pt.base[m]) * pt.f1[m];
    dcos += dbase * T(0.5) *
            (p.cos_m[m] - quot<FAST_DIV>(pt.c95, pt.sv) * p.sin_m[m]) *
            T(0.95);
  }
  drmean = T(0);
  dfc12 = T(0);
#pragma unroll
  for (int j = 0; j < kNA; ++j) {
    drmean += df2[j] * pt.fc12 * pt.e[j] * (-(T(2) * p.eta)) *
              (pt.x2 - T(j) * p.delta);
    dfc12 += df2[j] * pt.e[j];
  }
  if (!(pt.dsum <= T(2) * (p.rca + T(1)))) drmean = T(0);
}

// One step of width W of a reduce-scatter: acc[i], i < W, takes column
// i + (lane & W) summed over the two lanes that differ in bit W. W is a
// template constant, so that every index of acc is known at compile time
// and acc stays in registers (a loop-variant width put it in local
// memory).
template <int W, typename T, int N>
__device__ __forceinline__ void reduce_step(T (&acc)[N], int lane) {
  static_assert(2 * W <= N, "reduce_step: width beyond the columns");
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const T send = upper ? acc[i] : acc[i + W];
    const T keep = upper ? acc[i + W] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// Reduce-scatter of 32 column sums over the warp, 31 shuffles: at the end
// lane l holds column l in acc[0]. The order of the additions is fixed.
template <typename T>
__device__ __forceinline__ void reduce_scatter32(T (&acc)[32], int lane) {
  reduce_step<16>(acc, lane);
  reduce_step<8>(acc, lane);
  reduce_step<4>(acc, lane);
  reduce_step<2>(acc, lane);
  reduce_step<1>(acc, lane);
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
