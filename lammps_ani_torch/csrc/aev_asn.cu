// Assignment-compacted AEV kernels for Hopper (sm_90a), written by hand.
//
// Four kernels replace the four Pallas kernels of the rebuild and the
// forward of lammps_ani_tpu/ops/aev_asn.py (the `pallas_asn` engine). Each
// computes what its TPU kernel computes (see lammps_ani_torch/ops/aev_asn.py
// for the contract and the plain PyTorch version of each); none copies its
// block structure:
//
//   * The TPU kernels read materialized, lane-padded candidate planes
//     ([NC, wpad] per coordinate, built by halo copies) and gather from
//     them one 128-lane vreg at a time. Here each warp computes its window
//     lane's bin, wrap shift and shifted position from the [NC, cap] grid
//     (aev_common.cuh), and gathers through `idx` by plain loads.
//   * The TPU ranks lanes with triangular-ones matmuls and inverts the
//     ranking by bisection, because it can neither scan nor scatter. Here
//     a warp ranks 32 lanes at a time with __ballot_sync and __popc
//     prefixes, and the inverse table is a scatter.
//   * Section and column sums were one-hot mask matmuls (bf16x3 splits in
//     f32); here they are warp shuffle reductions in a fixed order.
//   * The TPU grid runs in order and carries the overflow and deficit
//     planes as running maxima; here they are integer atomicMax per block
//     into a per-species int array set to -2^20 by the wrapper.
//
// Distances: d2 = (dx dx + dy dy) + dz dz with each operation rounded on
// its own (no fused multiply-add), dist = sqrt(max(d2, 1e-12)), as the
// plain versions compute them, so the keep and cutoff decisions, and with
// them every integer output, agree bit for bit.
//
// Plain C interface (loaded with ctypes): every entry point takes host
// arrays of int and double parameters, device pointers, and the CUDA
// stream; it launches on that stream, allocates nothing, and returns
// cudaGetLastError() after its launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -shared -Xcompiler -fPIC -o libaev_asn.so aev_asn.cu

#include <cstdint>

#include "aev_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // one warp per row (center slot)
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxNR = 16;         // radial shifts per species (ANI: 16)
constexpr int kMaxBlocks = 28;     // species-pair blocks (7 species)
constexpr int kDeadSlot = 127;     // rank2 of a lane without a packed slot
constexpr int kFloor = -(1 << 20);
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T d2_rn(T dx, T dy, T dz) {
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Window lane w (= offset o * cap + slot b of the 27-bin window) of bin
// `cell`: the grid slot it reads and its wrap shift.
__device__ __forceinline__ int window_slot(const Grid& g, int cell, int w,
                                           int& sx, int& sy, int& sz) {
  const int o = w / g.cap, b = w - o * g.cap;
  int ox, oy, oz;
  offset_of(o, 1, ox, oy, oz);
  return neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * g.cap + b;
}

// Compact sections: species s holds lanes [off, off + k) of every row.
struct Sections {
  int n;
  int species[kMaxS], off[kMaxS], k[kMaxS];
};

// Block-level max of per-species values, then one atomicMax per species.
__device__ __forceinline__ void flush_species_max(int* red, int* out) {
  __syncthreads();
  if (threadIdx.x < kMaxS && red[threadIdx.x] != kFloor)
    atomicMax(&out[threadIdx.x], red[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// Assignment build, part 1 — replaces aev_asn.py:243 _build_inv_kernel.
//
// inv[row, w] = off_s + (rank of window lane w among the row's lanes of
// species s within the keep radius, self excluded, ascending w), or
// kpad - 1 for a lane kept by no section; ovf[s] = max over rows of
// (count_s - k_s). Bound: its least work is writing the [NC, cap, wpad]
// int16 table (bytes); the window tests are ~5 operations per lane.
// Design: one warp per row scans the window 32 lanes at a time; a lane
// reads its candidate's species first and its position only if the
// species can be kept; ranks come from one ballot and popcount per
// section, the carry of each section stays in a register.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) asn_build_inv_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, int16_t* __restrict__ inv,
    int* __restrict__ ovf, Grid g, int wpad, int kpad, Sections sec,
    T keep_r2) {
  __shared__ int red[kMaxS];
  if (threadIdx.x < kMaxS) red[threadIdx.x] = kFloor;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int nrows = g.nx * g.ny * g.nz * g.cap;
  if (row < nrows) {
    T h[9];
    for (int i = 0; i < 9; ++i) h[i] = hmat[i];
    const int cell = row / g.cap, a = row - cell * g.cap;
    const int csp = sp[row];
    const T cx = pos[row * 3], cy = pos[row * 3 + 1], cz = pos[row * 3 + 2];
    const int W = 27 * g.cap, self_lane = 13 * g.cap + a;
    const unsigned below = (1u << lane) - 1u;
    int carry[kMaxS];
#pragma unroll
    for (int si = 0; si < kMaxS; ++si) carry[si] = 0;
    int16_t* out = inv + (size_t)row * wpad;
    for (int base = 0; base < wpad; base += 32) {
      const int w = base + lane;
      int sw = -1;
      if (csp >= 0 && w < W && w != self_lane) {
        int sx, sy, sz;
        const int q = window_slot(g, cell, w, sx, sy, sz);
        sw = sp[q];
        if (sw >= 0) {
          T px, py, pz;
          candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
          if (!(d2_rn(cx - px, cy - py, cz - pz) <= keep_r2)) sw = -1;
        }
      }
      int v = kpad - 1;
#pragma unroll
      for (int si = 0; si < kMaxS; ++si) {
        if (si < sec.n) {
          const bool m = sw == sec.species[si];
          const unsigned bal = __ballot_sync(kFull, m);
          if (m) v = sec.off[si] + carry[si] + __popc(bal & below);
          carry[si] += __popc(bal);
        }
      }
      out[w] = (int16_t)v;
    }
    if (lane == 0) {
#pragma unroll
      for (int si = 0; si < kMaxS; ++si)
        if (si < sec.n) atomicMax(&red[sec.species[si]], carry[si] - sec.k[si]);
    }
  }
  flush_species_max(red, ovf);
}

// ---------------------------------------------------------------------------
// Assignment build, part 2 — replaces aev_asn.py:309 _build_idx_kernel.
//
// idx[row, k] = the window lane w with inv[row, w] == k, or wpad where no
// lane maps to k. The TPU bisects per-section cumulative counts because it
// cannot scatter; here it is a scatter. Bound: reading inv and writing idx
// (bytes). Design: one warp per row fills its idx row with wpad, then
// scatters (a __syncwarp orders the two).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) asn_build_idx_kernel(
    const int16_t* __restrict__ inv, int16_t* __restrict__ idx, int nrows,
    int wpad, int kpad) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= nrows) return;
  int16_t* out = idx + (size_t)row * kpad;
  for (int k = lane; k < kpad; k += 32) out[k] = (int16_t)wpad;
  __syncwarp();
  const int16_t* in = inv + (size_t)row * wpad;
  for (int w = lane; w < wpad; w += 32) {
    const int v = in[w];
    if (v >= 0 && v < kpad - 1) out[v] = (int16_t)w;
  }
}

// ---------------------------------------------------------------------------
// Fused step forward — replaces aev_asn.py:1178 _step_fused_kernel.
//
// Per row, one pass over its compact lanes (window lanes read through
// idx; dead lanes idx == wpad sit at dist 1e6):
//   rad[row, si*NR + k] = sum over section si's lanes within Rcr of
//     0.25 fc(d) exp(-eta (d - mu0 - k delta)^2),
//   rad[row, srl] = sum of the XTB repulsion half pair energies;
//   stage 2: the first a_s lanes of section si within Rca (ascending lane)
//     go to packed slots a_off + rank of cmp[row, field, slot] (fields ux,
//     uy, uz, d, fc, dfc), rank2[row, k] = that slot (127: none), and
//     deficit[s] = max over rows of (count within Rca - a_s).
// Bound: writing rad, cmp and rank2 and reading idx (bytes) against 16
// exps per in-cutoff lane (operations); see chip_smoke.py for the count.
// Design: one warp per row, 32 lanes at a time, section by section, so
// the 16 radial accumulators of one section stay in registers; stage-2
// ranks from one ballot per chunk; sums by warp shuffles.
// ---------------------------------------------------------------------------
template <typename T>
struct StepParams {
  Grid g;
  int wpad, kpad, NR, atot, srl;
  int has_rep, env, kf15;  // env: 0 smooth, 1 cosine, 2 none
  Sections sec;
  int a_s[kMaxS], a_off[kMaxS];  // stage-2 cap and packed offset (0: none)
  T rc, eta, mu0, delta, pi_rc, tiny_e, pmin;
  T rca, pi_rca, dfc_k, big;
  T rep_rc, kf, a2b, one_m, pi;
  T alpha[kMaxS], zeff[kMaxS];  // per section
};

// Repulsion half pair energy (aev_asn.py `_rep_pair`), in Hartree.
template <typename T>
__device__ __forceinline__ T rep_half(const StepParams<T>& p, T dist, T a_ij,
                                      T z_ij) {
  const T r_b = dist * p.a2b;
  const T r_kf = p.kf15 ? r_b * m_sqrt(r_b) : m_exp(p.kf * m_log(r_b));
  const T core = z_ij / r_b * m_exp(-a_ij * r_kf);
  const T x = dist / p.rep_rc;
  T env = T(1);
  if (p.env == 0) {
    T x2 = x * x;
    x2 = x2 < T(0) ? T(0) : (x2 > p.one_m ? p.one_m : x2);
    const T u = T(1) - x2;
    env = m_exp(T(1) - T(1) / u);
  } else if (p.env == 1) {
    env = T(0.5) * m_cos(p.pi * x) + T(0.5);
  }
  const T e = T(0.5) * (core * env);
  return (e > p.pmin || e < -p.pmin) ? e : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_step_fused_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const int16_t* __restrict__ idx,
    T* __restrict__ rad, T* __restrict__ cmp, int* __restrict__ rank2,
    int* __restrict__ deficit, StepParams<T> p) {
  __shared__ int red[kMaxS];
  if (threadIdx.x < kMaxS) red[threadIdx.x] = kFloor;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const Grid& g = p.g;
  const int nrows = g.nx * g.ny * g.nz * g.cap;
  if (row < nrows) {
    T h[9];
    for (int i = 0; i < 9; ++i) h[i] = hmat[i];
    const int cell = row / g.cap;
    const int csp = sp[row];
    const T cx = pos[row * 3], cy = pos[row * 3 + 1], cz = pos[row * 3 + 2];
    const unsigned below = (1u << lane) - 1u;
    const int A = p.atot;
    T a_i = T(0), z_i = T(0);
    for (int si = 0; si < p.sec.n; ++si) {
      if (csp == p.sec.species[si]) {
        a_i = p.alpha[si];
        z_i = p.zeff[si];
      }
    }
    const int16_t* irow = idx + (size_t)row * p.kpad;
    int* r2row = rank2 + (size_t)row * p.kpad;
    T* crow = cmp + (size_t)row * 6 * A;
    T* rrow = rad + (size_t)row * (p.srl + 1);
    T rep = T(0);
    int k_total = 0;
    for (int si = 0; si < p.sec.n; ++si) {
      const int off = p.sec.off[si], end = off + p.sec.k[si];
      const int a_s = p.a_s[si], a_off = p.a_off[si];
      k_total = end;
      const T z_ij = p.zeff[si] * z_i;
      T a_ij = p.alpha[si] * a_i;
      a_ij = m_sqrt(a_ij > T(1e-12) ? a_ij : T(1e-12));
      T acc[kMaxNR];
#pragma unroll
      for (int kk = 0; kk < kMaxNR; ++kk) acc[kk] = T(0);
      int carry = 0;
      for (int base = off; base < end; base += 32) {
        const int k = base + lane;
        const bool in_sec = k < end;
        const int w = in_sec ? (int)irow[k] : p.wpad;
        const bool valid = w >= 0 && w < p.wpad;
        T dx = T(0), dy = T(0), dz = T(0), dist = T(1e6);
        if (valid) {
          int sx, sy, sz;
          const int q = window_slot(g, cell, w, sx, sy, sz);
          T px, py, pz;
          candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
          dx = cx - px;
          dy = cy - py;
          dz = cz - pz;
          const T d2 = d2_rn(dx, dy, dz);
          dist = m_sqrt(d2 > T(1e-12) ? d2 : T(1e-12));
        }
        if (valid && dist <= p.rc) {
          const T pref = T(0.25) * (T(0.5) * m_cos(dist * p.pi_rc) + T(0.5));
          const T x = dist - p.mu0;
#pragma unroll
          for (int kk = 0; kk < kMaxNR; ++kk) {
            if (kk < p.NR) {
              const T xk = x - T(kk) * p.delta;
              T e = m_exp(-p.eta * xk * xk);
              e = e > p.tiny_e ? e : T(0);
              const T t = pref * e;
              acc[kk] += t > p.pmin ? t : T(0);
            }
          }
        }
        if (p.has_rep && valid && z_ij > T(0) && dist < p.rep_rc)
          rep += rep_half(p, dist, a_ij, z_ij);
        int r2 = kDeadSlot;
        if (a_s > 0) {
          const bool m = valid && dist <= p.rca;
          const unsigned bal = __ballot_sync(kFull, m);
          const int rank = carry + __popc(bal & below);
          if (m && rank < a_s) {
            r2 = a_off + rank;
            const bool live = dist > T(1e-6);
            const T d = live ? dist : p.big;
            const T inv_d = T(1) / d;
            const bool in = live && dist <= p.rca;
            crow[r2] = dx * inv_d;
            crow[A + r2] = dy * inv_d;
            crow[2 * A + r2] = dz * inv_d;
            crow[3 * A + r2] = d;
            crow[4 * A + r2] =
                in ? T(0.5) * m_cos(dist * p.pi_rca) + T(0.5) : T(0);
            crow[5 * A + r2] = in ? p.dfc_k * m_sin(dist * p.pi_rca) : T(0);
          }
          carry += __popc(bal);
        }
        if (in_sec) r2row[k] = r2;
      }
      for (int kk = 0; kk < p.NR; ++kk) {
        const T s = warp_sum(acc[kk]);
        if (lane == kk) rrow[si * p.NR + kk] = s;
      }
      if (a_s > 0) {
        const int filled = carry < a_s ? carry : a_s;
        for (int t = a_off + filled + lane; t < a_off + a_s; t += 32) {
          crow[t] = T(0);
          crow[A + t] = T(0);
          crow[2 * A + t] = T(0);
          crow[3 * A + t] = p.big;
          crow[4 * A + t] = T(0);
          crow[5 * A + t] = T(0);
        }
        if (lane == 0) atomicMax(&red[p.sec.species[si]], carry - a_s);
      }
    }
    for (int k = k_total + lane; k < p.kpad; k += 32) r2row[k] = kDeadSlot;
    rep = warp_sum(rep);
    if (lane == 0) rrow[p.srl] = rep;
  }
  flush_species_max(red, deficit);
}

// ---------------------------------------------------------------------------
// Packed angular pairs — replaces aev_asn.py:1794 _packed_fwd_kernel.
//
// For each row (a center atom) and each species-pair block b, the sum over
// the block's pair lanes t (same species: the strict upper triangle of
// slot pairs; cross species: the rectangle; the lane -> (slot 1, slot 2)
// table comes from the host) of
//   2 fc1 fc2 exp(-eta (rmean - shf_a_j)^2) ((1 + cos(theta - shf_z_m))/2)^zeta
// into column b*32 + j*8 + m. One launch per occupancy tier, each with the
// tier's own table. Bound: operations (4 exps and 8 zeta powers, each an
// exp and a log for zeta 14.1, per pair lane) against reading the 5 slot
// fields and writing 32 columns per block (bytes). Design: one warp per
// row stages its 5 x atot slot values in shared memory; each lane takes
// every 32nd pair lane of a block and keeps the 32 column sums in
// registers; a reduce-scatter of 31 shuffles leaves column l on lane l,
// which writes it (coalesced). No atomics.
// ---------------------------------------------------------------------------
template <typename T>
struct PackedParams : AngConsts<T> {
  int rows, atot, n_blocks;
  int base[kMaxBlocks], q[kMaxBlocks];
  T pmin;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_packed_fwd_kernel(
    const T* __restrict__ cat, const int* __restrict__ table,
    T* __restrict__ out, PackedParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int A = p.atot;
  T* s = reinterpret_cast<T*>(smem_raw) + warp * 5 * A;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= p.rows) return;
  const T* in = cat + (size_t)row * 5 * A;
  for (int i = lane; i < 5 * A; i += 32) s[i] = in[i];
  __syncwarp();
  T* orow = out + (size_t)row * p.n_blocks * kNAZ;
  for (int b = 0; b < p.n_blocks; ++b) {
    T acc[kNAZ];
#pragma unroll
    for (int i = 0; i < kNAZ; ++i) acc[i] = T(0);
    const int end = p.base[b] + p.q[b];
    for (int t = p.base[b] + lane; t < end; t += 32) {
      const int i1 = table[3 * t], i2 = table[3 * t + 1];
      PairTerms<T> pt;
      pair_terms_core<T>(p, s[i1], s[A + i1], s[2 * A + i1], s[i2],
                         s[A + i2], s[2 * A + i2], s[3 * A + i1],
                         s[3 * A + i2], s[4 * A + i1], s[4 * A + i2], pt);
#pragma unroll
      for (int j = 0; j < kNA; ++j) {
        const T f2 = pt.fc12 * pt.e[j];
#pragma unroll
        for (int m = 0; m < kNZ; ++m) {
          const T c = f2 * pt.f1[m];
          acc[j * kNZ + m] += c > p.pmin ? c : T(0);
        }
      }
    }
    // reduce-scatter: after the step of width w, acc[i] holds column
    // i + (lane's bits >= w); at the end lane l holds column l
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
      const bool upper = (lane & w) != 0;
#pragma unroll
      for (int i = 0; i < w; ++i) {
        const T send = upper ? acc[i] : acc[i + w];
        const T keep = upper ? acc[i + w] : acc[i];
        acc[i] = keep + __shfl_xor_sync(kFull, send, w);
      }
    }
    orow[b * kNAZ + lane] = T(2) * acc[0];
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

Grid grid_from(const int* ip) { return Grid{ip[0], ip[1], ip[2], ip[3]}; }

// ip layout: n, species[8], off[8], k[8]
bool sections_from(const int* ip, Sections& s) {
  s.n = ip[0];
  if (s.n < 0 || s.n > kMaxS) return false;
  for (int i = 0; i < kMaxS; ++i) {
    s.species[i] = ip[1 + i];
    s.off[i] = ip[1 + kMaxS + i];
    s.k[i] = ip[1 + 2 * kMaxS + i];
    if (i < s.n && (s.species[i] < 0 || s.species[i] >= kMaxS)) return false;
  }
  return true;
}
constexpr int kSecInts = 1 + 3 * kMaxS;

int row_blocks(int nrows) {
  return (nrows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

bool grid_ok(const Grid& g, int wpad, int kpad) {
  return g.cap >= 1 && wpad >= 27 * g.cap && wpad % 32 == 0 &&
         wpad < 32768 && kpad % 32 == 0 && kpad >= 32 && kpad < 32768;
}

// ip: nx ny nz cap wpad kpad | sections; fp: keep_r^2
template <typename T>
int asn_build_inv(const int* ip, const double* fp, const void* pos,
                  const void* sp, const void* h, void* inv, void* ovf,
                  void* stream) {
  const Grid g = grid_from(ip);
  const int wpad = ip[4], kpad = ip[5];
  Sections sec;
  if (!sections_from(ip + 6, sec) || !grid_ok(g, wpad, kpad))
    return cudaErrorInvalidValue;
  const int nrows = g.nx * g.ny * g.nz * g.cap;
  asn_build_inv_kernel<T><<<row_blocks(nrows), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (int16_t*)inv, (int*)ovf, g,
      wpad, kpad, sec, (T)fp[0]);
  return (int)cudaGetLastError();
}

// ip: nrows wpad kpad
int asn_build_idx(const int* ip, const double*, const void* inv, void* idx,
                  void* stream) {
  const int nrows = ip[0], wpad = ip[1], kpad = ip[2];
  if (nrows < 0 || wpad < 32 || wpad >= 32768 || kpad < 32 || kpad >= 32768)
    return cudaErrorInvalidValue;
  asn_build_idx_kernel<<<row_blocks(nrows), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int16_t*)inv, (int16_t*)idx, nrows, wpad, kpad);
  return (int)cudaGetLastError();
}

// ip: nx ny nz cap wpad kpad NR atot srl has_rep env kf15 | sections |
//     a_s[8] a_off[8]
// fp: rc eta mu0 delta tiny_e pmin rca big rep_rc kf alpha[8] zeff[8]
template <typename T>
int asn_step_fused(const int* ip, const double* fp, const void* pos,
                   const void* sp, const void* h, const void* idx, void* rad,
                   void* cmp, void* rank2, void* deficit, void* stream) {
  StepParams<T> p;
  p.g = grid_from(ip);
  p.wpad = ip[4];
  p.kpad = ip[5];
  p.NR = ip[6];
  p.atot = ip[7];
  p.srl = ip[8];
  p.has_rep = ip[9];
  p.env = ip[10];
  p.kf15 = ip[11];
  if (!sections_from(ip + 12, p.sec) || !grid_ok(p.g, p.wpad, p.kpad) ||
      p.NR < 1 || p.NR > kMaxNR || p.atot < 0 || p.atot > kDeadSlot)
    return cudaErrorInvalidValue;
  const int* st = ip + 12 + kSecInts;
  for (int i = 0; i < kMaxS; ++i) {
    p.a_s[i] = st[i];
    p.a_off[i] = st[kMaxS + i];
    p.alpha[i] = (T)fp[10 + i];
    p.zeff[i] = (T)fp[10 + kMaxS + i];
  }
  const double rc = fp[0], rca = fp[6];
  p.rc = (T)rc;
  p.eta = (T)fp[1];
  p.mu0 = (T)fp[2];
  p.delta = (T)fp[3];
  p.tiny_e = (T)fp[4];
  p.pmin = (T)fp[5];
  p.pi_rc = (T)(kPi / rc);
  p.rca = (T)rca;
  p.pi_rca = (T)(kPi / rca);
  p.dfc_k = (T)(-0.5 * kPi / rca);
  p.big = (T)fp[7];
  p.rep_rc = (T)fp[8];
  p.kf = (T)fp[9];
  p.a2b = (T)1.8897261258369282;
  p.one_m = (T)(1.0 - 1e-6);
  p.pi = (T)kPi;
  const int nrows = p.g.nx * p.g.ny * p.g.nz * p.g.cap;
  asn_step_fused_kernel<T><<<row_blocks(nrows), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const int16_t*)idx,
      (T*)rad, (T*)cmp, (int*)rank2, (int*)deficit, p);
  return (int)cudaGetLastError();
}

// ip: rows atot n_blocks zeta_int | base[28] q[28]
// fp: rca eta zeta mu0 delta tiny cos_m[8] sin_m[8] pmin
template <typename T>
int asn_packed_fwd(const int* ip, const double* fp, const void* cat,
                   const void* table, void* out, void* stream) {
  PackedParams<T> p;
  p.rows = ip[0];
  p.atot = ip[1];
  p.n_blocks = ip[2];
  p.zeta_int = ip[3];
  if (p.rows < 0 || p.atot < 1 || p.atot > kDeadSlot || p.n_blocks < 1 ||
      p.n_blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  for (int b = 0; b < kMaxBlocks; ++b) {
    p.base[b] = ip[4 + b];
    p.q[b] = ip[4 + kMaxBlocks + b];
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
  p.pmin = (T)fp[6 + 2 * kNZ];
  if (p.rows == 0) return cudaSuccess;
  const size_t smem = sizeof(T) * kWarpsPerBlock * 5 * p.atot;
  cudaError_t err = set_smem(asn_packed_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_packed_fwd_kernel<T><<<row_blocks(p.rows), kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const T*)cat, (const int*)table, (T*)out, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define AEV_ASN_ENTRY(T, SUF)                                                 \
  extern "C" int asn_build_inv_##SUF(const int* ip, const double* fp,        \
                                     const void* pos, const void* sp,        \
                                     const void* h, void* inv, void* ovf,    \
                                     void* stream) {                         \
    return asn_build_inv<T>(ip, fp, pos, sp, h, inv, ovf, stream);           \
  }                                                                           \
  extern "C" int asn_step_fused_##SUF(                                       \
      const int* ip, const double* fp, const void* pos, const void* sp,      \
      const void* h, const void* idx, void* rad, void* cmp, void* rank2,     \
      void* deficit, void* stream) {                                         \
    return asn_step_fused<T>(ip, fp, pos, sp, h, idx, rad, cmp, rank2,       \
                             deficit, stream);                               \
  }                                                                           \
  extern "C" int asn_packed_fwd_##SUF(const int* ip, const double* fp,       \
                                      const void* cat, const void* table,    \
                                      void* out, void* stream) {             \
    return asn_packed_fwd<T>(ip, fp, cat, table, out, stream);               \
  }

AEV_ASN_ENTRY(float, f32)
AEV_ASN_ENTRY(double, f64)

extern "C" int asn_build_idx_any(const int* ip, const double* fp,
                                 const void* inv, void* idx, void* stream) {
  return asn_build_idx(ip, fp, inv, idx, stream);
}

extern "C" const char* aev_asn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
