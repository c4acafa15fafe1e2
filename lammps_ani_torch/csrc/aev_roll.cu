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
  int zeta_floor;  // floor(zeta), for the f32 split power (pair_powers)
  T zeta_frac;     // zeta - floor(zeta)
  int npres, pres[kMaxS];  // the species with caps > 0, ascending
};

// Shared memory of the angular forward (the backward has its own layout,
// bwd_smem):
//   window  wpos [W][3] (shifted), wsp [W]           (W = 27 cap)
//   slots   field-major [nf][atot][cap] of T, lane [atot][cap] of int
//   tail    [3 W + 9 cap] of T, of which the forward uses one int
template <typename T>
struct AngSmem {
  T* wpos;
  int* wsp;
  T* slot;   // fields: 0 ux 1 uy 2 uz 3 d 4 fc 5 dfc
  int* lane;
  T* tail;   // what follows (the deficit's reduction)
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
// Bound (chip_smoke.py OPS): per slot pair, fp32 instructions over the
// card's instruction rate and special-function results (the split power's
// lg2 and ex2, the 4 shifts' ex2, the square root) over its rate, as the
// asn packed backward; beside them the window tests and the per-neighbour
// chain, and the bytes of the cotangent.
// Design: one block per bin, `warps` warps (the host picks the count that
// keeps the most warps resident per SM in the shared memory each needs).
// The block stages the bin's 27-bin window once (stage_window); each warp
// then takes the bin's centers one at a time from a shared counter:
//   * compaction by ballot: the warp reads the window 32 lanes at a time,
//     one distance per lane, and ranks each species' in-Rca lanes by
//     popcount with a carry per species, so the first caps[s] of species
//     s land in its slots in ascending lane order, as compact_center
//     (angular_fwd) puts them; the slots (u, d, fc, dfc, window lane) go
//     to the warp's shared scratch (fc and dfc by the hardware cosine and
//     sine in f32: the argument lies in [0, pi]);
//   * per species-pair block, as asn_packed_bwd_kernel: pass 1 gives each
//     slot pair to one lane, which leaves the pair's dcos, drmean / 2 and
//     dfc12 in shared memory (f32: the split power and the fast divisions);
//     pass 2 gives each slot to one lane, which walks its partners in
//     index order and adds to the slot's five sums: no atomics;
//   * one lane a slot chains the sums to the slot's lane cotangent; fcen
//     is their warp sum (a fixed tree); the center's slots and lanes are
//     kept in shared memory, by center.
// Then the window's storage becomes the wing: each warp owns a range of
// window lanes and adds the kept slots that fall in it, center after
// center (a center's slots name distinct lanes), so every wing entry is a
// sum in center order and two calls agree bit for bit. The block writes
// the wing, and the bin's dh partial from per-offset wing sums (0 for an
// interior bin: every shift is 0); dh_reduce_kernel sums the partials.
// ---------------------------------------------------------------------------
constexpr int kBwdMaxWarps = 8;

// Per-warp scratch of angular_bwd, in T: the center's slots field after
// field, [6][A] (ux uy uz d fc, in the packed kernels' order, which
// add_partner reads, then dfc), their five cotangent sums [5][A], one
// block's pair scalars [3][Q] and its 32 column cotangents; then the
// slots' window lanes, int [A]. Rounded to 16 bytes.
template <typename T>
__host__ __device__ size_t bwd_warp_bytes(int A, int Q) {
  const size_t b = sizeof(T) * (11 * (size_t)A + 3 * (size_t)Q + kNAZ) +
                   sizeof(int) * (size_t)A;
  return (b + 15) & ~(size_t)15;
}

// Dynamic shared memory of angular_bwd: the window (later the wing), the
// centers' slot cotangents and lanes [cap][A], the centers' species [cap],
// then each warp's scratch.
template <typename T>
__host__ __device__ size_t bwd_warps_off(int cap, int A) {
  return sizeof(WinLane<T>) * 27 * (size_t)cap +
         sizeof(WinLane<T>) * (size_t)cap * A +
         ((sizeof(int) * (size_t)cap + 15) & ~(size_t)15);
}

template <typename T>
size_t bwd_smem(int cap, int A, int Q, int warps) {
  return bwd_warps_off<T>(cap, A) + (size_t)warps * bwd_warp_bytes<T>(A, Q);
}

// c[i] for a loop-variant i: selections over the unrolled entries, so that
// c stays in registers (an index unknown at compile time would put it in
// local memory).
__device__ __forceinline__ int pick(const int (&c)[kMaxS], int i) {
  int v = 0;
#pragma unroll
  for (int k = 0; k < kMaxS; ++k)
    if (k == i) v = c[k];
  return v;
}

// One center of angular_bwd, on one warp: its fcen, and its kept slots'
// lane cotangents and window lanes in res[0, A) (lane -1: no lane).
template <typename T>
__device__ __forceinline__ void bwd_center(
    const AngParams<T>& p, const Grid& g, const int* csp,
    const T* __restrict__ ga, T* __restrict__ fcen, const WinLane<T>* win,
    WinLane<T>* res, unsigned char* scratch, int cell, int a, int Q,
    int lane) {
  const int cap = g.cap, W = 27 * cap, A = p.atot;
  T* s = reinterpret_cast<T*>(scratch);
  T* o = s + 6 * A;
  T* pb = o + 5 * A;
  T* gsm = pb + 3 * Q;
  int* slane = reinterpret_cast<int*>(gsm + kNAZ);
  const int me = cell * cap + a;
  if (csp[a] < 0) {
    for (int q = lane; q < A; q += 32) res[q].sp = -1;
    if (lane < 3) fcen[(size_t)me * 3 + lane] = T(0);
    return;
  }
  for (int q = lane; q < A; q += 32) {
    slane[q] = -1;
#pragma unroll
    for (int f = 0; f < 5; ++f) o[f * A + q] = T(0);
  }
  // the center's position: its own window lane (offset 13, no shift)
  const WinLane<T> ctr = win[13 * cap + a];
  const T cx = ctr.x, cy = ctr.y, cz = ctr.z;
  const int self_lane = 13 * cap + a;
  const unsigned below = (1u << lane) - 1u;
  int carry[kMaxS];  // by position in p.pres
#pragma unroll
  for (int pi = 0; pi < kMaxS; ++pi) carry[pi] = 0;
  // compaction: the first caps[s] in-Rca lanes of species s, ascending
  __syncwarp();
  for (int base = 0; base < W; base += 32) {
    const int w = base + lane;
    int ws = -1;
    T dx = T(0), dy = T(0), dz = T(0), d = T(0);
    if (w < W && w != self_lane) {
      const WinLane<T> c = win[w];
      if (c.sp >= 0) {
        dx = cx - c.x;
        dy = cy - c.y;
        dz = cz - c.z;
        d = pair_dist(dx, dy, dz);
        if (d <= p.rca) ws = c.sp;
      }
    }
    int q = -1;  // the slot this lane fills, if any
#pragma unroll
    for (int pi = 0; pi < kMaxS; ++pi) {
      if (pi >= p.npres) break;
      const int si = p.pres[pi];
      const bool m = ws == si;
      const unsigned bal = __ballot_sync(kFull, m);
      const int r = carry[pi] + __popc(bal & below);
      if (m && r < p.caps[si]) q = p.slot0[si] + r;
      carry[pi] += __popc(bal);
    }
    if (q >= 0) {
      const bool valid = d > T(1e-6);
      const T d_safe = valid ? d : p.big;
      const T inv = T(1) / d_safe;
      s[q] = dx * inv;
      s[A + q] = dy * inv;
      s[2 * A + q] = dz * inv;
      s[3 * A + q] = d_safe;
      s[4 * A + q] = valid ? T(0.5) * cos_0pi(d * p.pi_rca) + T(0.5) : T(0);
      s[5 * A + q] =
          valid ? (T(-0.5) * p.pi_rca) * sin_0pi(d * p.pi_rca) : T(0);
      slane[q] = valid ? w : -1;
    }
  }
  __syncwarp();
  const int AL = p.S * (p.S + 1) / 2 * kNAZ;
  const T(&gb)[kNAZ] = *reinterpret_cast<const T(*)[kNAZ]>(gsm);
  for (int p1 = 0; p1 < p.npres; ++p1) {
    for (int p2 = p1; p2 < p.npres; ++p2) {
      const int s1 = p.pres[p1], s2 = p.pres[p2];
      const bool same = s1 == s2;
      const int n1 = min(pick(carry, p1), p.caps[s1]);
      const int n2 = min(pick(carry, p2), p.caps[s2]);
      const int q = same ? n1 * (n1 - 1) / 2 : n1 * n2;
      if (q == 0) continue;
      const int off1 = p.slot0[s1], off2 = p.slot0[s2];
      // the block's column cotangents, each unordered pair once: scale 2
      gsm[lane] =
          T(2) * ga[(size_t)me * AL + triu_index(s1, s2, p.S) * kNAZ + lane];
      __syncwarp();
      // pass 1: each pair's three scalars
      for (int t = lane; t < q; t += 32) {
        int j, k;
        if (same)
          block_pair<kTri>(t, n1, n1, j, k);
        else
          block_pair<kCross>(t, n1, n2, j, k);
        const int i1 = off1 + j, i2 = off2 + k;
        PairTerms<T> pt;
        pair_terms_geom<T>(p, s[i1], s[A + i1], s[2 * A + i1], s[i2],
                           s[A + i2], s[2 * A + i2], s[3 * A + i1],
                           s[3 * A + i2], s[4 * A + i1], s[4 * A + i2], pt);
        pair_powers<T>(p, pt);
        T dcos, drmean, dfc12;
        pair_cotangents<T, true>(p, pt, gb, dcos, drmean, dfc12);
        pb[t] = dcos;
        pb[Q + t] = T(0.5) * drmean;
        pb[2 * Q + t] = dfc12;
      }
      __syncwarp();
      // pass 2: each slot walks its partners in index order
      const int w1 = n1, w2 = same ? 0 : n2;
      for (int it = lane; it < w1 + w2; it += 32) {
        T gs[5] = {T(0), T(0), T(0), T(0), T(0)};
        int slot;
        if (same) {
          // pairs (k, j), k < j: index j - 1 at k = 0, then + n1 - 2 - k;
          // pairs (j, k), k > j: consecutive from the row's start
          const int j = it;
          slot = off1 + j;
          int t_lo = j - 1, t_hi = tri_start(j, n1);
          for (int k = 0; k < n1; ++k) {
            if (k == j) continue;
            add_partner<T>(gs, pb, Q, k < j ? t_lo : t_hi, s, A, off1 + k);
            if (k < j)
              t_lo += n1 - 2 - k;
            else
              ++t_hi;
          }
        } else {
          // arm 1 slot i: pairs i n2 + k; arm 2 slot i: pairs j n2 + i
          const bool arm1 = it < w1;
          const int i = arm1 ? it : it - w1;
          slot = (arm1 ? off1 : off2) + i;
          const int po = arm1 ? off2 : off1, cnt = arm1 ? n2 : n1;
          const int stride = arm1 ? 1 : n2;
          int t = arm1 ? i * n2 : i;
          for (int k = 0; k < cnt; ++k, t += stride)
            add_partner<T>(gs, pb, Q, t, s, A, po + k);
        }
#pragma unroll
        for (int f = 0; f < 5; ++f) o[f * A + slot] += gs[f];
      }
      __syncwarp();
    }
  }
  // slot cotangents -> lane cotangents; fcen their sum
  T fx = T(0), fy = T(0), fz = T(0);
  for (int q = lane; q < A; q += 32) {
    WinLane<T> r;
    r.x = r.y = r.z = T(0);
    r.sp = slane[q];
    if (r.sp >= 0) {
      const T inv = T(1) / s[3 * A + q];
      const T ux = s[q], uy = s[A + q], uz = s[2 * A + q];
      const T gux = o[q], guy = o[A + q], guz = o[2 * A + q];
      const T gu_dot_u = gux * ux + guy * uy + guz * uz;
      const T g_cd = o[3 * A + q] + o[4 * A + q] * s[5 * A + q] -
                     gu_dot_u * inv;
      r.x = gux * inv + g_cd * ux;
      r.y = guy * inv + g_cd * uy;
      r.z = guz * inv + g_cd * uz;
      fx += r.x;
      fy += r.y;
      fz += r.z;
    }
    res[q] = r;
  }
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  if (lane == 0) {
    fcen[(size_t)me * 3] = fx;
    fcen[(size_t)me * 3 + 1] = fy;
    fcen[(size_t)me * 3 + 2] = fz;
  }
  __syncwarp();  // the scratch is the next center's
}

template <typename T>
__global__ void __launch_bounds__(32 * kBwdMaxWarps) angular_bwd_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const T* __restrict__ ga,
    T* __restrict__ fcen, T* __restrict__ wing, T* __restrict__ dh_part,
    Grid g, AngParams<T> p, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[27];
  __shared__ T osum[27][3];
  __shared__ int next;
  const int cell = blockIdx.x, cap = g.cap, W = 27 * cap, A = p.atot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  WinLane<T>* win = reinterpret_cast<WinLane<T>*>(smem_raw);
  WinLane<T>* res = win + W;
  int* csp = reinterpret_cast<int*>(res + cap * A);
  unsigned char* scratch = smem_raw + bwd_warps_off<T>(cap, A) +
                           warp * bwd_warp_bytes<T>(A, Q);
  if (threadIdx.x == 0) next = 0;
  for (int i = threadIdx.x; i < cap; i += blockDim.x)
    csp[i] = sp[cell * cap + i];
  unsigned keep = 0;
#pragma unroll
  for (int pi = 0; pi < kMaxS; ++pi)
    if (pi < p.npres) keep |= 1u << p.pres[pi];
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  stage_window(pos, sp, h, g, cell, keep, win, tab);
  for (;;) {
    int a = 0;
    if (lane == 0) a = atomicAdd(&next, 1);
    a = __shfl_sync(kFull, a, 0);
    if (a >= cap) break;
    bwd_center(p, g, csp, ga, fcen, win, res + a * A, scratch, cell, a, Q,
               lane);
  }
  __syncthreads();
  // the window is done with: its storage becomes the wing, [W][3]
  T* wing_s = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) wing_s[i] = T(0);
  __syncthreads();
  const int per = (W + nw - 1) / nw, lo = warp * per, hi = min(W, lo + per);
  for (int c = 0; c < cap; ++c) {
    for (int q = lane; q < A; q += 32) {
      const WinLane<T> r = res[c * A + q];
      if (r.sp >= lo && r.sp < hi) {
        wing_s[3 * r.sp] -= r.x;
        wing_s[3 * r.sp + 1] -= r.y;
        wing_s[3 * r.sp + 2] -= r.z;
      }
    }
    __syncwarp();
  }
  __syncthreads();
  T* out = wing + (size_t)cell * 3 * W;
  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) out[i] = wing_s[i];
  // dh[m][c] = sum over offsets of S_m (sum of the offset's wing_c)
  const int iz = cell % g.nz, iy = (cell / g.nz) % g.ny;
  const int ix = cell / (g.ny * g.nz);
  if (ix > 0 && ix < g.nx - 1 && iy > 0 && iy < g.ny - 1 && iz > 0 &&
      iz < g.nz - 1) {
    if (threadIdx.x < 9) dh_part[(size_t)cell * 9 + threadIdx.x] = T(0);
    return;
  }
  for (int off = warp; off < 27; off += nw) {
    T v[3] = {T(0), T(0), T(0)};
    for (int b = lane; b < cap; b += 32)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] += wing_s[3 * (off * cap + b) + c];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = warp_sum(v[c]);
      if (lane == 0) osum[off][c] = v[c];
    }
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    const int m = threadIdx.x / 3, c = threadIdx.x % 3;
    T acc = T(0);
    for (int off = 0; off < 27; ++off) {
      const int sm = (tab[off].y >> (2 * m) & 3) - 1;
      if (sm) acc += T(sm) * osum[off][c];
    }
    dh_part[(size_t)cell * 9 + threadIdx.x] = acc;
  }
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
  const double zf = floor(fp[2]);
  p.zeta_floor = (int)zf;
  p.zeta_frac = (T)(fp[2] - zf);
  p.npres = 0;
  for (int s = 0; s < kMaxS; ++s) {
    p.pres[s] = 0;
    if (p.caps[s] > 0) p.pres[p.npres++] = s;
  }
  return true;
}

// Dynamic shared memory of the angular forward (see AngSmem).
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
  if (!ang_params(ip, fp, p) || g.cap < 1 || g.cap > 1024 || p.atot < 1 ||
      p.zeta_floor < 0)
    return cudaErrorInvalidValue;
  // the largest species-pair block's slot pairs
  int Q = 1;
  for (int s1 = 0; s1 < p.S; ++s1)
    for (int s2 = s1; s2 < p.S; ++s2) {
      const int q = s1 == s2 ? p.caps[s1] * (p.caps[s1] - 1) / 2
                             : p.caps[s1] * p.caps[s2];
      if (q > Q) Q = q;
    }
  // the warp count whose shared memory lets the most warps reside on an
  // SM (228 KB, 1 KB reserved a block; at most 32 blocks and 64 warps; ties:
  // more warps a block)
  constexpr size_t kSmPerSm = 228 * 1024, kPerBlock = 1024;
  int warps = 0, best = 0;
  for (int nw = 1; nw <= kBwdMaxWarps; ++nw) {
    const size_t smem = bwd_smem<T>(g.cap, p.atot, Q, nw);
    if (smem > kSmPerSm - kPerBlock) break;
    const int blocks = min((int)(kSmPerSm / (smem + kPerBlock)),
                           min(32, 64 / nw));
    const int resident = nw * blocks;
    if (resident >= best) {
      best = resident;
      warps = nw;
    }
  }
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem<T>(g.cap, p.atot, Q, warps);
  cudaError_t err = set_smem(angular_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = g.nx * g.ny * g.nz;
  cudaStream_t st = (cudaStream_t)stream;
  angular_bwd_kernel<T><<<nc, 32 * warps, smem, st>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const T*)ga, (T*)fcen,
      (T*)wing, (T*)dh_part, g, p, Q);
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
