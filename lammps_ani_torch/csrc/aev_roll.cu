// Roll-grid AEV kernels for Hopper (sm_90a), written by hand.
//
// Four kernels replace the four Pallas kernels of
// lammps_ani_tpu/ops/aev_pallas.py. Each computes what its TPU kernel
// computes (see lammps_ani_torch/ops/aev_roll.py for the contract and the
// plain PyTorch version of each); none copies its block structure:
//
//   * The TPU kernels read materialized candidate planes
//     ([NC, (2s+1)^3 cap] per coordinate, built by halo copies) in
//     candidate groups sized for 16 MB of VMEM. Here a block serves one
//     bin and computes each candidate's bin, periodic wrap S and shifted
//     position p + S h itself from the [NC, cap] grid: nothing is
//     materialized, and the window is read through L1/L2 (or staged once
//     in shared memory for the 27-bin angular window).
//   * The TPU grid runs in order, so its kernels carry sums across grid
//     steps (fcen over candidate groups, dh over the whole grid, the
//     deficit as a running max). Blocks here run in any order: fcen and
//     wing are complete within a block, dh is written as per-block
//     partials and summed in a fixed order by a second one-block kernel
//     (deterministic), and the deficit is an integer atomicMax.
//   * Dead lanes: empty slots carry species -1 and are skipped; self is
//     excluded by lane index (lane == self_off * cap + slot); pairs count
//     at dist <= cutoff with dist = sqrt(max(d2, 1e-12)), as on the TPU.
//
// Plain C interface (loaded with ctypes): every entry point takes host
// arrays of int and double parameters, device pointers, and the CUDA
// stream; it launches on that stream, allocates nothing, and returns
// cudaGetLastError() after its launches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -shared -Xcompiler -fPIC -o libaev_roll.so aev_roll.cu

#include "aev_common.cuh"

namespace {

constexpr int kMaxNR = 16;  // radial shifts per species (ANI: 16)

// Fixed-order tree sum of vals[blockDim][9] into out[9] (thread 0 writes).
template <typename T>
__device__ void block_sum9(T* red, const T (&v)[9], T* out) {
  const int t = threadIdx.x, n = blockDim.x;
  for (int i = 0; i < 9; ++i) red[i * n + t] = v[i];
  __syncthreads();
  for (int i = t; i < 9; i += n) {
    T s = 0;
    for (int k = 0; k < n; ++k) s += red[i * n + k];
    out[i] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Radial forward — replaces aev_pallas.py:260 _radial_fwd_kernel.
//
// out[cell, a, s*NR + k] = sum over window lanes of species s within Rcr
//   0.25 fc(d) exp(-eta (d - mu0 - k delta)^2).
// Bound: its least work is writing the [NC, cap, S*16] output (bytes);
// the in-cutoff arithmetic (16 exps per pair) is smaller. As written it
// is bound by operations instead: every center tests every lane of its
// (2s+1)^3 cap window (125 cap at shell 2), of which about 1% lie
// within Rcr. Design: a block per bin; its cap x G threads split the
// window lanes G ways per center, keep the 16 shifts in registers, and
// sum the G partials in shared memory in a fixed order. The window is
// scanned once per present species (2 for water) so the accumulators
// stay 16 registers, not 16 x species.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void radial_fwd_kernel(const T* __restrict__ pos,
                                  const int* __restrict__ sp,
                                  const T* __restrict__ hmat,
                                  T* __restrict__ out, Grid g, int shell,
                                  int S, int NR, unsigned present, T rc,
                                  T eta, T mu0, T delta, T pi_rc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);  // [G][cap][NR]
  const int cell = blockIdx.x, cap = g.cap;
  const int G = blockDim.x / cap;
  const int a = threadIdx.x % cap, grp = threadIdx.x / cap;
  const int ns = 2 * shell + 1, n_off = ns * ns * ns;
  const int self_off = (n_off - 1) / 2;
  T h[9];
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  const int me = cell * cap + a;
  const int csp = sp[me];
  const T cx = pos[me * 3], cy = pos[me * 3 + 1], cz = pos[me * 3 + 2];
  for (int s = 0; s < S; ++s) {
    if (!((present >> s) & 1u)) continue;
    T acc[kMaxNR];
#pragma unroll
    for (int k = 0; k < kMaxNR; ++k) acc[k] = T(0);
    if (csp >= 0) {
      for (int o = 0; o < n_off; ++o) {
        int ox, oy, oz, sx, sy, sz;
        offset_of(o, shell, ox, oy, oz);
        const int nb = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz);
        for (int b = grp; b < cap; b += G) {
          const int q = nb * cap + b;
          if (sp[q] != s || (o == self_off && b == a)) continue;
          T px, py, pz;
          candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
          const T d = pair_dist(cx - px, cy - py, cz - pz);
          if (!(d <= rc)) continue;
          const T pref = T(0.25) * (T(0.5) * m_cos(d * pi_rc) + T(0.5));
          const T x = d - mu0;
#pragma unroll
          for (int k = 0; k < kMaxNR; ++k) {
            if (k < NR) {
              const T xk = x - T(k) * delta;
              acc[k] += pref * m_exp(-eta * xk * xk);
            }
          }
        }
      }
    }
    for (int k = 0; k < NR; ++k) red[(grp * cap + a) * NR + k] = acc[k];
    __syncthreads();
    for (int i = threadIdx.x; i < cap * NR; i += blockDim.x) {
      const int aa = i / NR, k = i % NR;
      T sum = T(0);
      for (int gg = 0; gg < G; ++gg) sum += red[(gg * cap + aa) * NR + k];
      out[((size_t)cell * cap + aa) * S * NR + s * NR + k] = sum;
    }
    __syncthreads();
  }
}

// gamma u for one (center, candidate) pair of the radial backward:
// gamma = sum_k ga[s_b*NR + k] 0.25 e_k (dfc - 2 eta x_k fc).
template <typename T>
__device__ __forceinline__ bool radial_pair_grad(
    T dx, T dy, T dz, const T* __restrict__ ga_row, int NR, T rc, T eta,
    T mu0, T delta, T pi_rc, T& gx, T& gy, T& gz) {
  const T d = pair_dist(dx, dy, dz);
  if (!(d <= rc)) return false;
  const T fc = T(0.5) * m_cos(d * pi_rc) + T(0.5);
  const T dfc = (T(-0.5) * pi_rc) * m_sin(d * pi_rc);
  const T x = d - mu0;
  T gamma = T(0);
  for (int k = 0; k < NR; ++k) {
    const T xk = x - T(k) * delta;
    const T db = T(0.25) * m_exp(-eta * xk * xk) *
                 (dfc - (T(2) * eta) * xk * fc);
    gamma += db * ga_row[k];
  }
  const T inv_d = T(1) / d;
  gx = gamma * dx * inv_d;
  gy = gamma * dy * inv_d;
  gz = gamma * dz * inv_d;
  return true;
}

// ---------------------------------------------------------------------------
// Radial backward — replaces aev_pallas.py:299 _radial_bwd_kernel.
//
// For the cotangent ga [NC, cap, S*NR]: per pair gamma u (u = center -
// candidate over d); fcen[cell, a] = sum_lanes gamma u (center role),
// wing[cell, lane] = -sum_centers gamma u (neighbor role, folded back to
// the owner bins by torch rolls), dh partial = sum_lanes S^T wing.
// Bound: its least work is reading ga and writing the wing slabs
// [NC, n_off cap, 3] (bytes). As written it is bound by operations, as
// the forward (window tests; 16 exps per in-cutoff pair). Design: phase
// A gives each center cap x G threads over its lanes (fcen, fixed-order
// partial sums); phase B gives each lane one thread over the bin's
// centers (wing and dh, no atomics). Each in-cutoff pair is evaluated
// twice — the price of writing both roles without atomics.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void radial_bwd_kernel(const T* __restrict__ pos,
                                  const int* __restrict__ sp,
                                  const T* __restrict__ hmat,
                                  const T* __restrict__ ga,
                                  T* __restrict__ fcen, T* __restrict__ wing,
                                  T* __restrict__ dh_part, Grid g, int shell,
                                  int S, int NR, unsigned present, T rc,
                                  T eta, T mu0, T delta, T pi_rc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);  // max(G*cap*3, blockDim*9)
  const int cell = blockIdx.x, cap = g.cap;
  const int G = blockDim.x / cap;
  const int ns = 2 * shell + 1, n_off = ns * ns * ns;
  const int self_off = (n_off - 1) / 2;
  const int SR = S * NR;
  T h[9];
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];

  // phase A: center role
  {
    const int a = threadIdx.x % cap, grp = threadIdx.x / cap;
    const int me = cell * cap + a;
    const int csp = sp[me];
    const T cx = pos[me * 3], cy = pos[me * 3 + 1], cz = pos[me * 3 + 2];
    const T* ga_row = ga + (size_t)me * SR;
    T fx = T(0), fy = T(0), fz = T(0);
    if (csp >= 0) {
      for (int o = 0; o < n_off; ++o) {
        int ox, oy, oz, sx, sy, sz;
        offset_of(o, shell, ox, oy, oz);
        const int nb = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz);
        for (int b = grp; b < cap; b += G) {
          const int q = nb * cap + b;
          const int bs = sp[q];
          if (bs < 0 || !((present >> bs) & 1u) || (o == self_off && b == a))
            continue;
          T px, py, pz, gx, gy, gz;
          candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
          if (radial_pair_grad(cx - px, cy - py, cz - pz, ga_row + bs * NR,
                               NR, rc, eta, mu0, delta, pi_rc, gx, gy, gz)) {
            fx += gx;
            fy += gy;
            fz += gz;
          }
        }
      }
    }
    red[(grp * cap + a) * 3 + 0] = fx;
    red[(grp * cap + a) * 3 + 1] = fy;
    red[(grp * cap + a) * 3 + 2] = fz;
    __syncthreads();
    for (int i = threadIdx.x; i < cap * 3; i += blockDim.x) {
      const int aa = i / 3, c = i % 3;
      T sum = T(0);
      for (int gg = 0; gg < G; ++gg) sum += red[(gg * cap + aa) * 3 + c];
      fcen[((size_t)cell * cap + aa) * 3 + c] = sum;
    }
    __syncthreads();
  }

  // phase B: neighbor role (wing) and the box cotangent
  T dh[9];
  for (int i = 0; i < 9; ++i) dh[i] = T(0);
  const int W = n_off * cap;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int o = w / cap, b = w % cap;
    int ox, oy, oz, sx, sy, sz;
    offset_of(o, shell, ox, oy, oz);
    const int nb = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz);
    const int q = nb * cap + b;
    const int bs = sp[q];
    T wx = T(0), wy = T(0), wz = T(0);
    if (bs >= 0 && ((present >> bs) & 1u)) {
      T px, py, pz;
      candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
      for (int a = 0; a < cap; ++a) {
        const int me = cell * cap + a;
        if (sp[me] < 0 || (o == self_off && b == a)) continue;
        T gx, gy, gz;
        if (radial_pair_grad(pos[me * 3] - px, pos[me * 3 + 1] - py,
                             pos[me * 3 + 2] - pz,
                             ga + (size_t)me * SR + bs * NR, NR, rc, eta,
                             mu0, delta, pi_rc, gx, gy, gz)) {
          wx -= gx;
          wy -= gy;
          wz -= gz;
        }
      }
    }
    T* wp = wing + ((size_t)cell * W + w) * 3;
    wp[0] = wx;
    wp[1] = wy;
    wp[2] = wz;
    const T sv[3] = {T(sx), T(sy), T(sz)};
    const T wv[3] = {wx, wy, wz};
    for (int m = 0; m < 3; ++m)
      for (int c = 0; c < 3; ++c) dh[m * 3 + c] += sv[m] * wv[c];
  }
  block_sum9(red, dh, dh_part + (size_t)cell * 9);
}

// ---------------------------------------------------------------------------
// Angular kernels: shared parameters and per-center compaction
// ---------------------------------------------------------------------------

template <typename T>
struct AngParams : AngConsts<T> {
  T pi_rca, big;
  int S, atot;
  int caps[kMaxS], slot0[kMaxS];
};

// Shared memory of the angular kernels:
//   window  wpos [W][3] (shifted), wsp [W]           (W = 27 cap)
//   slots   field-major [nf][atot][cap] of T, lane [atot][cap] of int
template <typename T>
struct AngSmem {
  T* wpos;
  int* wsp;
  T* slot;   // fields: 0 ux 1 uy 2 uz 3 d 4 fc 5 dfc (+ 6..10 cotangents)
  int* lane;
  T* tail;   // what follows (wing accumulators, reductions)
  int atot, cap;
  __device__ T& f(int field, int q, int a) {
    return slot[(field * atot + q) * cap + a];
  }
};

template <typename T>
__device__ AngSmem<T> ang_smem(unsigned char* raw, int W, int atot, int cap,
                               int nf) {
  AngSmem<T> s;
  s.atot = atot;
  s.cap = cap;
  s.wpos = reinterpret_cast<T*>(raw);
  s.slot = s.wpos + 3 * W;
  s.tail = s.slot + (size_t)nf * atot * cap;
  s.wsp = reinterpret_cast<int*>(s.tail + 3 * W + 9 * cap);
  s.lane = s.wsp + W;
  return s;
}

// Stage the bin's 27-bin window (shifted positions, species) in shared.
template <typename T>
__device__ void load_window(const T* __restrict__ pos,
                            const int* __restrict__ sp, const T* h,
                            const Grid& g, int cell, AngSmem<T>& sm) {
  const int W = 27 * g.cap;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int o = w / g.cap, b = w % g.cap;
    int ox, oy, oz, sx, sy, sz;
    offset_of(o, 1, ox, oy, oz);
    const int q = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * g.cap + b;
    T px, py, pz;
    candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
    sm.wpos[w * 3] = px;
    sm.wpos[w * 3 + 1] = py;
    sm.wpos[w * 3 + 2] = pz;
    sm.wsp[w] = sp[q];
  }
}

// Compact center a's in-Rca lanes into per-species slots, ascending lane
// order, the first caps[s] of species s; fills n_filled[s] and returns
// the worst count - cap over species with caps > 0.
template <typename T>
__device__ int compact_center(const AngParams<T>& p, AngSmem<T>& sm, int a,
                              T cx, T cy, T cz, int (&n_filled)[kMaxS]) {
  const int cap = sm.cap, W = 27 * cap, self_lane = 13 * cap + a;
  int deficit = -(1 << 20);
  for (int s = 0; s < p.S; ++s) {
    n_filled[s] = 0;
    if (p.caps[s] == 0) continue;
    int count = 0;
    for (int w = 0; w < W; ++w) {
      if (sm.wsp[w] != s || w == self_lane) continue;
      const T dx = cx - sm.wpos[w * 3], dy = cy - sm.wpos[w * 3 + 1],
              dz = cz - sm.wpos[w * 3 + 2];
      const T d = pair_dist(dx, dy, dz);
      if (!(d <= p.rca)) continue;
      if (count < p.caps[s]) {
        const int q = p.slot0[s] + count;
        const bool valid = d > T(1e-6);
        const T d_safe = valid ? d : p.big;
        const T inv = T(1) / d_safe;
        sm.f(0, q, a) = dx * inv;
        sm.f(1, q, a) = dy * inv;
        sm.f(2, q, a) = dz * inv;
        sm.f(3, q, a) = d_safe;
        sm.f(4, q, a) = valid ? T(0.5) * m_cos(d * p.pi_rca) + T(0.5) : T(0);
        sm.f(5, q, a) = valid ? (T(-0.5) * p.pi_rca) * m_sin(d * p.pi_rca)
                              : T(0);
        sm.lane[q * cap + a] = valid ? w : -1;
      }
      ++count;
    }
    n_filled[s] = count < p.caps[s] ? count : p.caps[s];
    deficit = max(deficit, count - p.caps[s]);
  }
  return deficit;
}

// Pair terms of slots q1, q2 of center a (aev_common.cuh pair_terms_core).
template <typename T>
__device__ __forceinline__ void pair_terms(const AngParams<T>& p,
                                           AngSmem<T>& sm, int q1, int q2,
                                           int a, PairTerms<T>& t) {
  pair_terms_core<T>(p, sm.f(0, q1, a), sm.f(1, q1, a), sm.f(2, q1, a),
                     sm.f(0, q2, a), sm.f(1, q2, a), sm.f(2, q2, a),
                     sm.f(3, q1, a), sm.f(3, q2, a), sm.f(4, q1, a),
                     sm.f(4, q2, a), t);
}

__device__ __forceinline__ int triu_index(int s1, int s2, int S) {
  return s1 * S - s1 * (s1 - 1) / 2 + (s2 - s1);
}

// ---------------------------------------------------------------------------
// Angular forward — replaces aev_pallas.py:737 _angular_fwd_kernel.
//
// Per center: compact its in-Rca window lanes into per-species slots
// (first caps[s] lanes of species s in ascending lane order, so a
// truncation drops the same neighbors as the TPU), then for every
// species-pair block (torchani triu order) sum over unordered slot pairs
//   2 fc1 fc2 exp(-eta (rmean - shf_a_j)^2) ((1 + cos(theta - shf_z_m))/2)^zeta
// into channels ch0 + j*8 + m. Also the worst per-species cap deficit.
// Bound: its least work is writing the [NC, cap, 896] output (bytes);
// per slot pair it needs 4 exps and 8 zeta powers (exp + log each, zeta
// 14.1 is not an integer). As written it is bound by operations and
// latency: one thread per center, so a block holds only cap threads.
// Design: one block per bin, one thread per center; the 27-bin window is
// staged once in shared memory and every center scans it from there;
// slots live in shared memory (field-major, so neighbouring threads touch
// neighbouring words); the 32 channels of a block accumulate in
// registers.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void angular_fwd_kernel(const T* __restrict__ pos,
                                   const int* __restrict__ sp,
                                   const T* __restrict__ hmat,
                                   T* __restrict__ out,
                                   int* __restrict__ deficit_out, Grid g,
                                   AngParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cell = blockIdx.x, cap = g.cap, a = threadIdx.x;
  AngSmem<T> sm = ang_smem<T>(smem_raw, 27 * cap, p.atot, cap, 6);
  T h[9];
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  load_window(pos, sp, h, g, cell, sm);
  __syncthreads();
  const int me = cell * cap + a;
  const int AL = p.S * (p.S + 1) / 2 * kNAZ;
  int n_filled[kMaxS];
  int deficit = -(1 << 20);
  if (sp[me] >= 0) {
    deficit = compact_center(p, sm, a, pos[me * 3], pos[me * 3 + 1],
                             pos[me * 3 + 2], n_filled);
  } else {
    for (int s = 0; s < kMaxS; ++s) n_filled[s] = 0;
  }
  for (int s1 = 0; s1 < p.S; ++s1) {
    if (p.caps[s1] == 0) continue;
    for (int s2 = s1; s2 < p.S; ++s2) {
      if (p.caps[s2] == 0) continue;
      T acc[kNAZ];
#pragma unroll
      for (int i = 0; i < kNAZ; ++i) acc[i] = T(0);
      const bool same = s1 == s2;
      for (int i = 0; i < n_filled[s1]; ++i) {
        const int q1 = p.slot0[s1] + i;
        for (int j = same ? i + 1 : 0; j < n_filled[s2]; ++j) {
          PairTerms<T> t;
          pair_terms(p, sm, q1, p.slot0[s2] + j, a, t);
#pragma unroll
          for (int jj = 0; jj < kNA; ++jj) {
            const T f2 = t.fc12 * t.e[jj];
#pragma unroll
            for (int m = 0; m < kNZ; ++m) acc[jj * kNZ + m] += f2 * t.f1[m];
          }
        }
      }
      T* o = out + (size_t)me * AL + triu_index(s1, s2, p.S) * kNAZ;
#pragma unroll
      for (int i = 0; i < kNAZ; ++i) o[i] = T(2) * acc[i];
    }
  }
  int* red = reinterpret_cast<int*>(sm.tail);
  if (a == 0) red[0] = -(1 << 20);
  __syncthreads();
  atomicMax(red, deficit);
  __syncthreads();
  if (a == 0) atomicMax(deficit_out, red[0]);
}

// ---------------------------------------------------------------------------
// Angular backward — replaces aev_pallas.py:777 _angular_bwd_kernel.
//
// Recomputes the compaction and the pair terms, chains the cotangent ga
// [NC, cap, AL] to per-slot cotangents of (u, d, fc), maps those back to
// the window lanes they were compacted from, and emits fcen (center
// role), wing (neighbor role, folded by torch rolls) and dh partials.
// Bound: its least work is reading the [NC, cap, 896] cotangent
// (bytes). As written it is bound by operations and latency, as the
// forward, plus the chain rule (about 2x the forward's arithmetic per
// pair). Design: as the forward; the slot
// cotangents accumulate in shared memory owned by their center's thread;
// the wing of the 27 cap window lanes accumulates in shared memory by
// atomicAdd (several centers share a lane), then one pass writes it with
// the dh partial sum.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void angular_bwd_kernel(const T* __restrict__ pos,
                                   const int* __restrict__ sp,
                                   const T* __restrict__ hmat,
                                   const T* __restrict__ ga,
                                   T* __restrict__ fcen, T* __restrict__ wing,
                                   T* __restrict__ dh_part, Grid g,
                                   AngParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cell = blockIdx.x, cap = g.cap, a = threadIdx.x;
  const int W = 27 * cap;
  AngSmem<T> sm = ang_smem<T>(smem_raw, W, p.atot, cap, 11);
  T* wing_s = sm.tail;          // [W][3]
  T* red = sm.tail + 3 * W;     // [9][cap]
  T h[9];
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  load_window(pos, sp, h, g, cell, sm);
  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) wing_s[i] = T(0);
  __syncthreads();
  const int me = cell * cap + a;
  const int AL = p.S * (p.S + 1) / 2 * kNAZ;
  int n_filled[kMaxS];
  for (int s = 0; s < kMaxS; ++s) n_filled[s] = 0;
  T fx = T(0), fy = T(0), fz = T(0);
  if (sp[me] >= 0) {
    compact_center(p, sm, a, pos[me * 3], pos[me * 3 + 1], pos[me * 3 + 2],
                   n_filled);
    for (int q = 0; q < p.atot; ++q)
      for (int f = 6; f < 11; ++f) sm.f(f, q, a) = T(0);
    const T two_eta = T(2) * p.eta;
    const T rlim = T(2) * (p.rca + T(1));
    for (int s1 = 0; s1 < p.S; ++s1) {
      if (p.caps[s1] == 0) continue;
      for (int s2 = s1; s2 < p.S; ++s2) {
        if (p.caps[s2] == 0) continue;
        const T* g_row = ga + (size_t)me * AL +
                         triu_index(s1, s2, p.S) * kNAZ;
        T gb[kNAZ];
#pragma unroll
        for (int i = 0; i < kNAZ; ++i) gb[i] = T(2) * g_row[i];
        const bool same = s1 == s2;
        for (int i = 0; i < n_filled[s1]; ++i) {
          const int q1 = p.slot0[s1] + i;
          for (int j = same ? i + 1 : 0; j < n_filled[s2]; ++j) {
            const int q2 = p.slot0[s2] + j;
            PairTerms<T> t;
            pair_terms(p, sm, q1, q2, a, t);
            T df2[kNA];
#pragma unroll
            for (int jj = 0; jj < kNA; ++jj) df2[jj] = T(0);
            T dcos = T(0);
#pragma unroll
            for (int m = 0; m < kNZ; ++m) {
              T df1 = T(0);
#pragma unroll
              for (int jj = 0; jj < kNA; ++jj) {
                const T gjm = gb[jj * kNZ + m];
                df1 += gjm * (t.fc12 * t.e[jj]);
                df2[jj] += gjm * t.f1[m];
              }
              const T dbase = df1 * (p.zeta / t.base[m]) * t.f1[m];
              dcos += dbase * T(0.5) *
                      (p.cos_m[m] - t.c95 / t.sv * p.sin_m[m]) * T(0.95);
            }
            T drmean = T(0), dfc12 = T(0);
#pragma unroll
            for (int jj = 0; jj < kNA; ++jj) {
              drmean += df2[jj] * t.fc12 * t.e[jj] * (-two_eta) *
                        (t.x2 - T(jj) * p.delta);
              dfc12 += df2[jj] * t.e[jj];
            }
            if (!(t.dsum <= rlim)) drmean = T(0);
            const T fc1 = sm.f(4, q1, a), fc2 = sm.f(4, q2, a);
            for (int c = 0; c < 3; ++c) {
              const T u1 = sm.f(c, q1, a), u2 = sm.f(c, q2, a);
              sm.f(6 + c, q1, a) += dcos * u2;
              sm.f(6 + c, q2, a) += dcos * u1;
            }
            sm.f(9, q1, a) += T(0.5) * drmean;
            sm.f(9, q2, a) += T(0.5) * drmean;
            sm.f(10, q1, a) += dfc12 * fc2;
            sm.f(10, q2, a) += dfc12 * fc1;
          }
        }
      }
    }
    // slot cotangents -> window lanes
    for (int s = 0; s < p.S; ++s) {
      for (int i = 0; i < n_filled[s]; ++i) {
        const int q = p.slot0[s] + i;
        const int w = sm.lane[q * cap + a];
        if (w < 0) continue;  // slot of a coincident pair: masked
        const T inv = T(1) / sm.f(3, q, a);
        const T ux = sm.f(0, q, a), uy = sm.f(1, q, a), uz = sm.f(2, q, a);
        const T gux = sm.f(6, q, a), guy = sm.f(7, q, a), guz = sm.f(8, q, a);
        const T gu_dot_u = gux * ux + guy * uy + guz * uz;
        const T g_cd = sm.f(9, q, a) + sm.f(10, q, a) * sm.f(5, q, a) -
                       gu_dot_u * inv;
        const T gx = gux * inv + g_cd * ux;
        const T gy = guy * inv + g_cd * uy;
        const T gz = guz * inv + g_cd * uz;
        fx += gx;
        fy += gy;
        fz += gz;
        atomicAdd(&wing_s[w * 3], -gx);
        atomicAdd(&wing_s[w * 3 + 1], -gy);
        atomicAdd(&wing_s[w * 3 + 2], -gz);
      }
    }
  }
  fcen[(size_t)me * 3] = fx;
  fcen[(size_t)me * 3 + 1] = fy;
  fcen[(size_t)me * 3 + 2] = fz;
  __syncthreads();
  T dh[9];
  for (int i = 0; i < 9; ++i) dh[i] = T(0);
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int o = w / cap;
    int ox, oy, oz, sx, sy, sz;
    offset_of(o, 1, ox, oy, oz);
    neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz);
    const T sv[3] = {T(sx), T(sy), T(sz)};
    T* wp = wing + ((size_t)cell * W + w) * 3;
    for (int c = 0; c < 3; ++c) {
      const T v = wing_s[w * 3 + c];
      wp[c] = v;
      for (int m = 0; m < 3; ++m) dh[m * 3 + c] += sv[m] * v;
    }
  }
  block_sum9(red, dh, dh_part + (size_t)cell * 9);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

Grid grid_from(const int* ip) { return Grid{ip[0], ip[1], ip[2], ip[3]}; }

int radial_groups(int cap) {
  int g = 256 / cap;
  if (g > cap) g = cap;
  return g < 1 ? 1 : g;
}

template <typename T>
int radial_fwd(const int* ip, const double* fp, const void* pos,
               const void* sp, const void* h, void* out, void* stream) {
  const Grid g = grid_from(ip);
  const int shell = ip[4], S = ip[5], NR = ip[6];
  const unsigned present = (unsigned)ip[7];
  if (NR > kMaxNR || g.cap < 1 || g.cap > 256) return cudaErrorInvalidValue;
  const int G = radial_groups(g.cap);
  const size_t smem = sizeof(T) * G * g.cap * NR;
  const T rc = (T)fp[0];
  radial_fwd_kernel<T><<<g.nx * g.ny * g.nz, G * g.cap, smem,
                         (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (T*)out, g, shell, S, NR,
      present, rc, (T)fp[1], (T)fp[2], (T)fp[3], (T)(kPi / fp[0]));
  return (int)cudaGetLastError();
}

template <typename T>
int radial_bwd(const int* ip, const double* fp, const void* pos,
               const void* sp, const void* h, const void* ga, void* fcen,
               void* wing, void* dh_part, void* dh, void* stream) {
  const Grid g = grid_from(ip);
  const int shell = ip[4], S = ip[5], NR = ip[6];
  const unsigned present = (unsigned)ip[7];
  if (NR > kMaxNR || g.cap < 1 || g.cap > 256) return cudaErrorInvalidValue;
  const int G = radial_groups(g.cap);
  const int threads = G * g.cap;
  const int n_red = G * g.cap * 3 > threads * 9 ? G * g.cap * 3 : threads * 9;
  const size_t smem = sizeof(T) * n_red;
  const int nc = g.nx * g.ny * g.nz;
  cudaStream_t st = (cudaStream_t)stream;
  radial_bwd_kernel<T><<<nc, threads, smem, st>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const T*)ga, (T*)fcen,
      (T*)wing, (T*)dh_part, g, shell, S, NR, present, (T)fp[0], (T)fp[1],
      (T)fp[2], (T)fp[3], (T)(kPi / fp[0]));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dh_reduce_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)dh_part, nc,
                                                 (T*)dh);
  return (int)cudaGetLastError();
}

template <typename T>
bool ang_params(const int* ip, const double* fp, AngParams<T>& p) {
  p.S = ip[4];
  p.zeta_int = ip[5];
  if (p.S > kMaxS) return false;
  p.atot = 0;
  for (int s = 0; s < kMaxS; ++s) {
    p.caps[s] = s < p.S ? ip[6 + s] : 0;
    p.slot0[s] = p.atot;
    p.atot += p.caps[s];
  }
  p.rca = (T)fp[0];
  p.eta = (T)fp[1];
  p.zeta = (T)fp[2];
  p.mu0 = (T)fp[3];
  p.delta = (T)fp[4];
  p.tiny = (T)fp[5];
  for (int m = 0; m < kNZ; ++m) {
    p.cos_m[m] = (T)fp[6 + m];
    p.sin_m[m] = (T)fp[6 + kNZ + m];
  }
  p.pi_rca = (T)(kPi / fp[0]);
  p.big = (T)(2.0 * fp[0] + 10.0);
  return true;
}

// Dynamic shared memory of the angular kernels (see AngSmem).
template <typename T>
size_t ang_smem_bytes(int cap, int atot, int nf) {
  const size_t W = 27 * (size_t)cap;
  return sizeof(T) * (3 * W + (size_t)nf * atot * cap + 3 * W + 9 * cap) +
         sizeof(int) * (W + (size_t)atot * cap);
}

template <typename T>
int angular_fwd(const int* ip, const double* fp, const void* pos,
                const void* sp, const void* h, void* out, void* deficit,
                void* stream) {
  const Grid g = grid_from(ip);
  AngParams<T> p;
  if (!ang_params(ip, fp, p) || g.cap < 1 || g.cap > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = ang_smem_bytes<T>(g.cap, p.atot, 6);
  cudaError_t err = set_smem(angular_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  angular_fwd_kernel<T><<<g.nx * g.ny * g.nz, g.cap, smem,
                          (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (T*)out, (int*)deficit, g,
      p);
  return (int)cudaGetLastError();
}

template <typename T>
int angular_bwd(const int* ip, const double* fp, const void* pos,
                const void* sp, const void* h, const void* ga, void* fcen,
                void* wing, void* dh_part, void* dh, void* stream) {
  const Grid g = grid_from(ip);
  AngParams<T> p;
  if (!ang_params(ip, fp, p) || g.cap < 1 || g.cap > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = ang_smem_bytes<T>(g.cap, p.atot, 11);
  cudaError_t err = set_smem(angular_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = g.nx * g.ny * g.nz;
  cudaStream_t st = (cudaStream_t)stream;
  angular_bwd_kernel<T><<<nc, g.cap, smem, st>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const T*)ga, (T*)fcen,
      (T*)wing, (T*)dh_part, g, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dh_reduce_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)dh_part, nc,
                                                 (T*)dh);
  return (int)cudaGetLastError();
}

}  // namespace

#define AEV_ROLL_ENTRY(T, SUF)                                               \
  extern "C" int radial_fwd_##SUF(const int* ip, const double* fp,          \
                                  const void* pos, const void* sp,          \
                                  const void* h, void* out, void* stream) { \
    return radial_fwd<T>(ip, fp, pos, sp, h, out, stream);                  \
  }                                                                          \
  extern "C" int radial_bwd_##SUF(const int* ip, const double* fp,          \
                                  const void* pos, const void* sp,          \
                                  const void* h, const void* ga,            \
                                  void* fcen, void* wing, void* dh_part,    \
                                  void* dh, void* stream) {                 \
    return radial_bwd<T>(ip, fp, pos, sp, h, ga, fcen, wing, dh_part, dh,   \
                         stream);                                            \
  }                                                                          \
  extern "C" int angular_fwd_##SUF(const int* ip, const double* fp,         \
                                   const void* pos, const void* sp,         \
                                   const void* h, void* out,                \
                                   void* deficit, void* stream) {           \
    return angular_fwd<T>(ip, fp, pos, sp, h, out, deficit, stream);        \
  }                                                                          \
  extern "C" int angular_bwd_##SUF(const int* ip, const double* fp,         \
                                   const void* pos, const void* sp,         \
                                   const void* h, const void* ga,           \
                                   void* fcen, void* wing, void* dh_part,   \
                                   void* dh, void* stream) {                \
    return angular_bwd<T>(ip, fp, pos, sp, h, ga, fcen, wing, dh_part, dh,  \
                          stream);                                           \
  }

AEV_ROLL_ENTRY(float, f32)
AEV_ROLL_ENTRY(double, f64)

extern "C" const char* aev_roll_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
