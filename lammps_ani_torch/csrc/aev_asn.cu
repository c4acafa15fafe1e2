// Assignment-compacted AEV kernels for Hopper (sm_90a), written by hand.
//
// Sixteen kernels replace sixteen Pallas kernels of
// lammps_ani_tpu/ops/aev_asn.py: the eight of the rebuild, the fused
// forward and the fused backward (the `pallas_asn` engine), the four of
// the per-channel surface (radial_aev_asn, angular_aev_asn), which share
// their device functions with the fused kernels and differ from them only
// in what is compiled out, and the four of the per-block angular pair
// stage (pair_stage "blocks" and "blocks_full"), which share the packed
// pair kernels' device functions. Each computes what its TPU kernel
// computes (see lammps_ani_torch/ops/aev_asn.py for the contract and the
// plain PyTorch version of each); none copies its block structure:
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
//   * The backward's gathers (slot -> compact lane through rank2, compact
//     lane -> window lane through inv) were 128-lane select-accumulate
//     loops; here the first is a load, the second a scatter over idx in
//     slot order through shared memory (the wing). Every floating-point
//     sum is taken in a fixed order (no floating-point atomics), so two
//     calls on the same inputs agree bit for bit; the box cotangent leaves
//     as per-block partials and is summed by dh_reduce_kernel
//     (aev_common.cuh).
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
#include <type_traits>

#include "aev_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // one warp per row (center slot)
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxNR = 16;         // radial shifts per species (ANI: 16)
constexpr int kMaxBlocks = 28;     // species-pair blocks (7 species)
constexpr int kDeadSlot = 127;     // rank2 of a lane without a packed slot
constexpr int kFloor = -(1 << 20);
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory (H100)

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

// Geometry of one compact lane of a center at (cx, cy, cz) in bin `cell`:
// a = center - candidate for the window lane w the lane reads (through
// idx); a dead lane (w == wpad) sits at dist 1e6 with a = 0. The step rows
// and the radial backward find the slot through a warp's window table
// (lane_geometry_tab) and leave the distance to lane_geom_at, so all see
// the same distances.
template <typename T>
struct LaneGeom {
  bool valid;
  T dx, dy, dz, dist;
};

// A dead lane: dist 1e6, a = 0.
template <typename T>
__device__ __forceinline__ LaneGeom<T> lane_dead() {
  return LaneGeom<T>{false, T(0), T(0), T(0), T(1e6)};
}

// A live lane reading grid slot q with wrap shift (sx, sy, sz): the one
// distance arithmetic of both ways of finding the slot.
template <typename T>
__device__ __forceinline__ LaneGeom<T> lane_geom_at(const T* pos, const T* h,
                                                    int q, int sx, int sy,
                                                    int sz, T cx, T cy,
                                                    T cz) {
  LaneGeom<T> r;
  r.valid = true;
  T px, py, pz;
  candidate_pos(pos, q, h, sx, sy, sz, px, py, pz);
  r.dx = cx - px;
  r.dy = cy - py;
  r.dz = cz - pz;
  const T d2 = d2_rn(r.dx, r.dy, r.dz);
  r.dist = m_sqrt(d2 > T(1e-12) ? d2 : T(1e-12));
  return r;
}

// The window of a row's bin, spread over a warp: lane o < 27 holds the
// first grid slot of window offset o's bin (bin * cap) and the offset's
// wrap shift, packed as (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4. Built
// once per row, it spares each compact lane the divisions and remainders
// of finding its offset's bin: a lane divides w by cap once and reads its
// offset's entry by a shuffle.
struct WindowTab {
  int base, shift;
};

__device__ __forceinline__ WindowTab window_tab(const Grid& g, int cell,
                                                int lane) {
  WindowTab t{0, 0};
  if (lane < 27) {
    int ox, oy, oz, sx, sy, sz;
    offset_of(lane, 1, ox, oy, oz);
    t.base = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * g.cap;
    t.shift = (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4;
  }
  return t;
}

// The geometry of the compact lane that reads window lane w: its grid slot
// and wrap shift from the row's window table, then lane_geom_at. Every lane of the warp calls it (the
// shuffles); idx names window lanes below 27 cap, or wpad (dead).
template <typename T>
__device__ __forceinline__ LaneGeom<T> lane_geometry_tab(
    const Grid& g, const WindowTab& tab, const T* pos, const T* h, T cx,
    T cy, T cz, int w, int wpad) {
  const bool valid = w >= 0 && w < wpad;
  const int o = valid ? w / g.cap : 0;
  const int base = __shfl_sync(kFull, tab.base, o & 31);
  const int shift = __shfl_sync(kFull, tab.shift, o & 31);
  if (!valid) return lane_dead<T>();
  return lane_geom_at(pos, h, base + (w - o * g.cap), (shift & 3) - 1,
                      (shift >> 2 & 3) - 1, (shift >> 4 & 3) - 1, cx, cy,
                      cz);
}

// Whether every window offset of bin `cell` stays inside the grid, so
// that every wrap shift of its window is 0: the bin's rows add nothing to
// the box cotangent (on the 16^3 grid of a 101,250-atom box, the 14^3
// interior bins).
__device__ __forceinline__ bool bin_interior(const Grid& g, int cell) {
  const int iz = cell % g.nz;
  const int iy = (cell / g.nz) % g.ny;
  const int ix = cell / (g.ny * g.nz);
  return ix > 0 && ix < g.nx - 1 && iy > 0 && iy < g.ny - 1 && iz > 0 &&
         iz < g.nz - 1;
}

// The packed wrap shift of window lane w from the row's table; a dead lane
// (w >= 27 cap) reads the center offset's (13), S = 0. Every lane of the
// warp calls it (the shuffle).
__device__ __forceinline__ int lane_shift(const Grid& g, const WindowTab& tab,
                                          int w) {
  const int o = (w >= 0 && w < 27 * g.cap) ? w / g.cap : 13;
  return __shfl_sync(kFull, tab.shift, o);
}

// Box cotangent of one lane cotangent g (aev_asn.py `_dh_from_compact`
// :595): dh[m][c] -= S_m g_c, S the packed shift of lane_shift.
template <typename T>
__device__ __forceinline__ void dh_add(int shift, T gx, T gy, T gz,
                                       T (&dh)[9]) {
  const T sv[3] = {T((shift & 3) - 1), T((shift >> 2 & 3) - 1),
                   T((shift >> 4 & 3) - 1)};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    dh[m * 3] -= sv[m] * gx;
    dh[m * 3 + 1] -= sv[m] * gy;
    dh[m * 3 + 2] -= sv[m] * gz;
  }
}

// Four consecutive values at p, in one access where the type allows: 16
// bytes for float, two of 16 for double, 8 for int16 (p aligned to that).
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void ld4(const int16_t* p, int (&v)[4]) {
  const short4 t = *reinterpret_cast<const short4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// The same for 16 column sums, 16 shuffles: the four steps leave column
// l & 15 summed over one half-warp on lane l, one more shuffle adds the
// other half's. Lanes l and l + 16 end with column l, the same bits.
template <typename T>
__device__ __forceinline__ T reduce_scatter16(T (&acc)[16], int lane) {
  reduce_step<8>(acc, lane);
  reduce_step<4>(acc, lane);
  reduce_step<2>(acc, lane);
  reduce_step<1>(acc, lane);
  return acc[0] + __shfl_xor_sync(kFull, acc[0], 16);
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
// int16 table of the real rows (bytes); the window tests are 9 fp32
// instructions per (row, real window lane).
// Design: one block per bin. The block stages the bin's 27-bin window once
// in shared memory (stage_window: each offset's bin and wrap shift found
// once, the shifted position and the species), so the cap rows of the bin
// share its gathers and shift products, then compacts it in place, in lane
// order, to the lanes whose species a section keeps (a block scan of
// ballots): the empty slots and the other species, a third of the window,
// are never tested. Its warps take the rows in turn. A row with no atom is filled
// with kpad - 1 by 16-byte stores and no scan. Otherwise the warp reads the
// compacted window 32 lanes at a time (one 16-byte shared load a lane:
// position, species and window lane); ranks come from one ballot and
// popcount per section, each section's carry in a register, so the answer
// is the one integer table whatever the order of the warps. The kept lanes
// are scattered into a per-warp int16 row of kpad - 1 in shared memory,
// which is written out in 16-byte stores. The per-species maxima go
// through shared memory (integer atomicMax), then one atomicMax per
// species to ovf.
// ---------------------------------------------------------------------------
constexpr int kInvWarps = 4;  // build_inv: warps per block (one bin)

// Dynamic shared memory of build_inv: the window, then each warp's row.
template <typename T>
size_t inv_smem(int cap, int wpad) {
  return sizeof(WinLane<T>) * 27 * (size_t)cap +
         sizeof(int16_t) * (size_t)kInvWarps * wpad;
}

template <typename T>
__global__ void __launch_bounds__(32 * kInvWarps) asn_build_inv_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, int16_t* __restrict__ inv,
    int* __restrict__ ovf, Grid g, int wpad, int kpad, Sections sec,
    T keep_r2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[27];
  __shared__ int red[kMaxS];
  __shared__ int wtot[kInvWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x, cap = g.cap, W = 27 * cap;
  WinLane<T>* win = reinterpret_cast<WinLane<T>*>(smem_raw);
  // the window compacted in place: sp holds the species | window lane << 4
  WinLane<T>* kept = win;
  int16_t* buf = reinterpret_cast<int16_t*>(win + W) + warp * wpad;
  if (threadIdx.x < kMaxS) red[threadIdx.x] = kFloor;
  unsigned keep = 0;
#pragma unroll
  for (int si = 0; si < kMaxS; ++si)
    if (si < sec.n) keep |= 1u << sec.species[si];
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  stage_window(pos, sp, h, g, cell, keep, win, tab);
  // compaction in lane order, blockDim lanes at a time, in place: a tile's
  // lanes are all read before the barrier, and land below the next tile
  const unsigned below = (1u << lane) - 1u;
  int n_kept = 0;
  for (int base = 0; base < W; base += 32 * kInvWarps) {
    const int w = base + threadIdx.x;
    WinLane<T> c;
    bool k = false;
    if (w < W) {
      c = win[w];
      k = c.sp >= 0;
    }
    const unsigned bal = __ballot_sync(kFull, k);
    if (lane == 0) wtot[warp] = __popc(bal);
    __syncthreads();
    int at = n_kept + __popc(bal & below), total = 0;
#pragma unroll
    for (int v = 0; v < kInvWarps; ++v) {
      if (v < warp) at += wtot[v];
      total += wtot[v];
    }
    if (k) {
      c.sp |= w << 4;
      kept[at] = c;
    }
    n_kept += total;
    __syncthreads();
  }
  const int16_t dead = (int16_t)(kpad - 1);
  const unsigned dead2 = (unsigned)(uint16_t)dead * 0x10001u;
  const int4 dead16 = make_int4(dead2, dead2, dead2, dead2);
  int4* b16 = reinterpret_cast<int4*>(buf);
  for (int a = warp; a < cap; a += kInvWarps) {
    const int row = cell * cap + a;
    int4* out = reinterpret_cast<int4*>(inv + (size_t)row * wpad);
    if (sp[row] < 0) {
      // no atom: every lane kpad - 1; counts 0, as the scan would give
      for (int i = lane; i < wpad / 8; i += 32) out[i] = dead16;
      if (lane < sec.n) atomicMax(&red[sec.species[lane]], -sec.k[lane]);
      continue;
    }
    for (int i = lane; i < wpad / 8; i += 32) b16[i] = dead16;
    __syncwarp();
    const T cx = pos[row * 3], cy = pos[row * 3 + 1], cz = pos[row * 3 + 2];
    const int self_lane = 13 * cap + a;
    int carry[kMaxS];
#pragma unroll
    for (int si = 0; si < kMaxS; ++si) carry[si] = 0;
    for (int base = 0; base < n_kept; base += 32) {
      const int i = base + lane;
      int sw = -1, w = 0;
      if (i < n_kept) {
        const WinLane<T> c = kept[i];
        w = c.sp >> 4;
        if (w != self_lane && d2_rn(cx - c.x, cy - c.y, cz - c.z) <= keep_r2)
          sw = c.sp & 15;
      }
      int v = -1;
#pragma unroll
      for (int si = 0; si < kMaxS; ++si) {
        if (si >= sec.n) break;
        const bool m = sw == sec.species[si];
        const unsigned bal = __ballot_sync(kFull, m);
        if (m) v = sec.off[si] + carry[si] + __popc(bal & below);
        carry[si] += __popc(bal);
      }
      if (v >= 0) buf[w] = (int16_t)v;
    }
    __syncwarp();
    for (int i = lane; i < wpad / 8; i += 32) out[i] = b16[i];
    __syncwarp();
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
// The step forward: one body, three kernels.
//
// Per row, one pass over its compact lanes (window lanes read through
// idx; dead lanes idx == wpad sit at dist 1e6):
//   radial part: rad[row, col0[si] + k] = sum over section si's lanes
//     within Rcr of 0.25 fc(d) exp(-eta (d - mu0 - k delta)^2),
//     rad[row, srl] = sum of the XTB repulsion half pair energies; in the
//     radial-only kernel, column blocks no section claims (the full
//     layout's absent species) are 0;
//   stage 2: the first a_s lanes of section si within Rca (ascending lane)
//     go to packed slots a_off + rank of cmp[row, field, slot] (fields ux,
//     uy, uz, d, fc, dfc), rank2[row, k] = that slot (int16; 127: none), and
//     deficit[s] = max over rows of (count within Rca - a_s).
//   asn_step_fused_kernel      both parts — replaces aev_asn.py:1178
//                              _step_fused_kernel;
//   asn_radial_fwd_asn_kernel  the radial part alone — replaces
//                              aev_asn.py:762 _radial_fwd_asn_kernel
//                              (body _radial_cols_mxu :717);
//   asn_compact_asn_kernel     stage 2 alone — replaces aev_asn.py:1153
//                              _compact_asn_kernel (body _stage2_compact
//                              :1044).
// The part a kernel does not need is compiled out (`if constexpr`), so a
// channel alone and the fused kernel execute the same expressions in the
// same order on the same lanes and agree bit for bit.
// Bound: writing rad, cmp and rank2 and reading idx (bytes) against the
// fp32 instructions and special-function results of the lanes (chip_smoke
// ASN_OPS: per assigned lane, per lane within Rcr, per repulsion lane, per
// packed slot); at the MD state bytes bound it.
// Design: one warp per row, 32 lanes at a time, section by section, so
// the 16 radial accumulators of one section stay in registers (the
// radial-only kernel keeps nothing else live, the stage-2 kernel none of
// them); the row's 27 window bins are found once (window_tab), not per
// lane; f32 Gaussians are one ex2 each of an argument prescaled by log2 e;
// stage-2 ranks come from one ballot per chunk; a section's 16 column
// sums leave by one reduce-scatter over the warp (16 shuffles), the
// repulsion sum by a warp sum. The lanes within the radial cutoff, and
// the kept lanes' slots, are packed first and computed on full warps
// (step_row).
// ---------------------------------------------------------------------------
template <typename T>
struct StepParams {
  Grid g;
  int wpad, kpad, NR, atot, srl;
  int has_rep, env, kf15;  // env: 0 smooth, 1 cosine, 2 none
  Sections sec;
  int a_s[kMaxS], a_off[kMaxS];  // stage-2 cap and packed offset (0: none)
  int col0[kMaxS];               // first radial column of each section
  T rc, eta, mu0, delta, pi_rc, dfc_rk, tiny_e, pmin;
  T geta;  // the Gaussian's exponent scale: -eta, in f32 -eta log2(e)
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

// d rep_half / d dist (aev_asn.py `_rep_pair`, the second value), for
// dist < rep_rc; the radial backward's. f32 divides by quot<true> and
// takes the hardware cosine and sine (pi x lies in [0, pi)); f64 computes
// what the forward's arithmetic would.
template <typename T>
__device__ __forceinline__ T rep_half_grad(const StepParams<T>& p, T dist,
                                           T a_ij, T z_ij) {
  const T r_b = dist * p.a2b;
  const T r_kf = p.kf15 ? r_b * m_sqrt(r_b) : m_exp(p.kf * m_log(r_b));
  const T core = quot<true>(z_ij, r_b) * m_exp(-a_ij * r_kf);
  const T dcore = core * (quot<true>(T(-1), r_b) -
                          quot<true>(a_ij * p.kf * r_kf, r_b));
  const T x = quot<true>(dist, p.rep_rc);
  T env = T(1), denv = T(0);
  if (p.env == 0) {
    T x2 = x * x;
    x2 = x2 < T(0) ? T(0) : (x2 > p.one_m ? p.one_m : x2);
    const T u = T(1) - x2;
    env = m_exp(T(1) - quot<true>(T(1), u));
    denv = env * quot<true>(T(-2) * x, p.rep_rc * u * u);
  } else if (p.env == 1) {
    env = T(0.5) * cos_0pi(p.pi * x) + T(0.5);
    denv = quot<true>(T(-0.5) * p.pi, p.rep_rc) * sin_0pi(p.pi * x);
  }
  return T(0.5) * (dcore * p.a2b * env + core * denv);
}

// Repulsion parameters of a center of species `csp` (0 for an empty slot
// or a species of no section).
template <typename T>
__device__ __forceinline__ void center_rep(const StepParams<T>& p, int csp,
                                           T& a_i, T& z_i) {
  a_i = T(0);
  z_i = T(0);
  for (int si = 0; si < p.sec.n; ++si) {
    if (csp == p.sec.species[si]) {
      a_i = p.alpha[si];
      z_i = p.zeff[si];
    }
  }
}

// Pair parameters of that center with the lanes of section si.
template <typename T>
__device__ __forceinline__ void section_rep(const StepParams<T>& p, int si,
                                            T a_i, T z_i, T& a_ij, T& z_ij) {
  z_ij = p.zeff[si] * z_i;
  a_ij = p.alpha[si] * a_i;
  a_ij = m_sqrt(a_ij > T(1e-12) ? a_ij : T(1e-12));
}

// One lane's radial terms, added to its section's NR accumulators
// (aev_asn.py `_radial_cols_mxu`).
template <typename T>
__device__ __forceinline__ void radial_cols_lane(const StepParams<T>& p,
                                                 bool valid, T dist,
                                                 T (&acc)[kMaxNR]) {
  if (valid && dist <= p.rc) {
    const T pref = T(0.25) * (T(0.5) * m_cos(dist * p.pi_rc) + T(0.5));
    const T x = dist - p.mu0;
#pragma unroll
    for (int kk = 0; kk < kMaxNR; ++kk) {
      if (kk < p.NR) {
        const T xk = x - T(kk) * p.delta;
        T e = gauss_of(p.geta * xk * xk);
        e = e > p.tiny_e ? e : T(0);
        const T t = pref * e;
        acc[kk] += t > p.pmin ? t : T(0);
      }
    }
  }
}

// Stage 2 for one chunk of 32 lanes of a section with cap a_s at packed
// offset a_off (aev_asn.py `_stage2_compact`): the lane's packed slot, or
// kDeadSlot. A kept lane leaves its offset and distance at its rank in the
// warp's slot buffer `sb` ([4][atot]: dx, dy, dz, dist), from which
// stage2_store writes the section's slots. `carry` counts the section's
// in-Rca lanes so far. Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ int stage2_lane(const StepParams<T>& p,
                                           const LaneGeom<T>& lg, int a_s,
                                           int a_off, unsigned below,
                                           int& carry, T* sb) {
  const int A = p.atot;
  int r2 = kDeadSlot;
  const bool m = lg.valid && lg.dist <= p.rca;
  const unsigned bal = __ballot_sync(kFull, m);
  const int rank = carry + __popc(bal & below);
  if (m && rank < a_s) {
    r2 = a_off + rank;
    sb[rank] = lg.dx;
    sb[A + rank] = lg.dy;
    sb[2 * A + rank] = lg.dz;
    sb[3 * A + rank] = lg.dist;
  }
  carry += __popc(bal);
  return r2;
}

// A section's a_s packed slots, slot t by lane t % 32 (the stores
// coalesce): the first `carry` (at most a_s) from the kept lanes' offsets
// and distances in `sb`, the six fields (ux, uy, uz, d, fc, dfc); the rest
// parked: u = 0, d = big, fc = dfc = 0.
template <typename T>
__device__ __forceinline__ void stage2_store(const StepParams<T>& p, int a_s,
                                             int a_off, int carry, int lane,
                                             const T* sb, T* crow) {
  const int A = p.atot;
  const int filled = carry < a_s ? carry : a_s;
  for (int t = lane; t < a_s; t += 32) {
    T ux = T(0), uy = T(0), uz = T(0), d = p.big, fc = T(0), dfc = T(0);
    if (t < filled) {
      const T dist = sb[3 * A + t];
      const bool live = dist > T(1e-6);
      d = live ? dist : p.big;
      const T inv_d = T(1) / d;
      const bool in = live && dist <= p.rca;
      ux = sb[t] * inv_d;
      uy = sb[A + t] * inv_d;
      uz = sb[2 * A + t] * inv_d;
      fc = in ? T(0.5) * m_cos(dist * p.pi_rca) + T(0.5) : T(0);
      dfc = in ? p.dfc_k * m_sin(dist * p.pi_rca) : T(0);
    }
    T* o = crow + a_off + t;
    o[0] = ux;
    o[A] = uy;
    o[2 * A] = uz;
    o[3 * A] = d;
    o[4 * A] = fc;
    o[5 * A] = dfc;
  }
}

// One row of the step forward, by one warp. `red`: the block's shared
// per-species deficit maxima (stage 2 only); `buf`: the warp's shared
// memory, step_buf_len entries. The geometry and the stage-2 ranks run
// over the section's lanes 32 at a time; the work that only some lanes
// have runs after, on full warps: the lanes within the radial or
// repulsion cutoff append their distances to `buf` by ballot (ascending
// lane) and the 16 shifts then run over `buf` 32 at a time (about 30 of a
// row's 100 assigned lanes are within Rcr, spread over five chunks); the
// kept lanes leave their offsets at their slot ranks, and the section's
// slots are then written 32 at a time, coalesced.
template <typename T, bool RADIAL, bool STAGE2>
__device__ __forceinline__ void step_row(
    const StepParams<T>& p, const T* __restrict__ pos,
    const int* __restrict__ sp, const T* __restrict__ hmat,
    const int16_t* __restrict__ idx, T* __restrict__ rad, T* __restrict__ cmp,
    int16_t* __restrict__ rank2, int* red, T* buf, int row, int lane) {
  const Grid& g = p.g;
  T h[9];
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  const int cell = row / g.cap;
  const int csp = sp[row];
  const T cx = pos[row * 3], cy = pos[row * 3 + 1], cz = pos[row * 3 + 2];
  const unsigned below = (1u << lane) - 1u;
  const int A = p.atot;
  const WindowTab tab = window_tab(g, cell, lane);
  T a_i = T(0), z_i = T(0);
  if constexpr (RADIAL) center_rep(p, csp, a_i, z_i);
  const int16_t* irow = idx + (size_t)row * p.kpad;
  int16_t* r2row = STAGE2 ? rank2 + (size_t)row * p.kpad : nullptr;
  T* crow = STAGE2 ? cmp + (size_t)row * 6 * A : nullptr;
  T* rrow = RADIAL ? rad + (size_t)row * (p.srl + 1) : nullptr;
  T* dbuf = buf;                                // [kpad] radial distances
  T* sb = buf + (RADIAL ? p.kpad : 0);          // [4][atot] kept slots
  T rep = T(0);
  unsigned claimed = 0;  // column blocks (of NR) that a section writes
  int k_total = 0;
  for (int si = 0; si < p.sec.n; ++si) {
    const int off = p.sec.off[si], end = off + p.sec.k[si];
    const int a_s = p.a_s[si], a_off = p.a_off[si], c0 = p.col0[si];
    k_total = end;
    T z_ij = T(0), a_ij = T(0);
    if constexpr (RADIAL) section_rep(p, si, a_i, z_i, a_ij, z_ij);
    const bool rep_on = RADIAL && p.has_rep && z_ij > T(0);
    int carry = 0, n_in = 0;
    for (int base = off; base < end; base += 32) {
      const int k = base + lane;
      const bool in_sec = k < end;
      const int w = in_sec ? (int)irow[k] : p.wpad;
      const LaneGeom<T> lg =
          lane_geometry_tab(g, tab, pos, h, cx, cy, cz, w, p.wpad);
      if constexpr (RADIAL) {
        const bool m = lg.valid && (lg.dist <= p.rc ||
                                    (rep_on && lg.dist < p.rep_rc));
        const unsigned bal = __ballot_sync(kFull, m);
        if (m) dbuf[n_in + __popc(bal & below)] = lg.dist;
        n_in += __popc(bal);
      }
      if constexpr (STAGE2) {
        int r2 = kDeadSlot;
        if (a_s > 0) r2 = stage2_lane(p, lg, a_s, a_off, below, carry, sb);
        if (in_sec) r2row[k] = (int16_t)r2;
      }
    }
    if constexpr (RADIAL) {
      __syncwarp();
      T acc[kMaxNR];
#pragma unroll
      for (int kk = 0; kk < kMaxNR; ++kk) acc[kk] = T(0);
      for (int base = 0; base < n_in; base += 32) {
        const bool in = base + lane < n_in;
        const T dist = in ? dbuf[base + lane] : T(1e6);
        radial_cols_lane(p, in, dist, acc);
        if (rep_on && in && dist < p.rep_rc)
          rep += rep_half(p, dist, a_ij, z_ij);
      }
      __syncwarp();
      // the NR column sums by one reduce-scatter (16 shuffles), lane kk
      // storing column kk; c0 is read once per section: indexing p.col0 in
      // a loop over the columns cost the fused kernel a fifth of its time
      // (0.69 against 0.57 ms at 101,250 atoms on an H100)
      const T s = reduce_scatter16(acc, lane);
      if (lane < p.NR) rrow[c0 + lane] = s;
      if constexpr (!STAGE2) claimed |= 1u << (c0 / p.NR);
    }
    if constexpr (STAGE2) {
      if (a_s > 0) {
        __syncwarp();
        stage2_store(p, a_s, a_off, carry, lane, sb, crow);
        __syncwarp();
        if (lane == 0) atomicMax(&red[p.sec.species[si]], carry - a_s);
      }
    }
  }
  if constexpr (STAGE2) {
    for (int k = k_total + lane; k < p.kpad; k += 32)
      r2row[k] = (int16_t)kDeadSlot;
  }
  if constexpr (RADIAL) {
    // the fused kernel writes compact columns only: every block claimed
    if constexpr (!STAGE2) {
      for (int c = lane; c < p.srl; c += 32)
        if (!((claimed >> (c / p.NR)) & 1u)) rrow[c] = T(0);
    }
    rep = warp_sum(rep);
    if (lane == 0) rrow[p.srl] = rep;
  }
}

// A step row's shared memory: kpad radial distances (a kernel with the
// radial part), then 4 x atot kept-slot values (with stage 2).
__host__ __device__ inline int step_buf_len(int kpad, int atot, bool radial,
                                            bool stage2) {
  return (radial ? kpad : 0) + (stage2 ? 4 * atot : 0);
}

// The calling warp's `len` entries of the block's dynamic shared memory
// (kWarpsPerBlock x len of T: step_smem).
template <typename T>
__device__ __forceinline__ T* warp_buf(int len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * len;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_step_fused_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const int16_t* __restrict__ idx,
    T* __restrict__ rad, T* __restrict__ cmp, int16_t* __restrict__ rank2,
    int* __restrict__ deficit, StepParams<T> p) {
  __shared__ int red[kMaxS];
  if (threadIdx.x < kMaxS) red[threadIdx.x] = kFloor;
  __syncthreads();
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row < p.g.nx * p.g.ny * p.g.nz * p.g.cap)
    step_row<T, true, true>(
        p, pos, sp, hmat, idx, rad, cmp, rank2, red,
        warp_buf<T>(step_buf_len(p.kpad, p.atot, true, true)), row,
        threadIdx.x & 31);
  flush_species_max(red, deficit);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_radial_fwd_asn_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const int16_t* __restrict__ idx,
    T* __restrict__ rad, StepParams<T> p) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row < p.g.nx * p.g.ny * p.g.nz * p.g.cap)
    step_row<T, true, false>(
        p, pos, sp, hmat, idx, rad, nullptr, nullptr, nullptr,
        warp_buf<T>(step_buf_len(p.kpad, p.atot, true, false)), row,
        threadIdx.x & 31);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_compact_asn_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const int16_t* __restrict__ idx,
    T* __restrict__ cmp, int16_t* __restrict__ rank2,
    int* __restrict__ deficit, StepParams<T> p) {
  __shared__ int red[kMaxS];
  if (threadIdx.x < kMaxS) red[threadIdx.x] = kFloor;
  __syncthreads();
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row < p.g.nx * p.g.ny * p.g.nz * p.g.cap)
    step_row<T, false, true>(
        p, pos, sp, hmat, idx, nullptr, cmp, rank2, red,
        warp_buf<T>(step_buf_len(p.kpad, p.atot, false, true)), row,
        threadIdx.x & 31);
  flush_species_max(red, deficit);
}

// ---------------------------------------------------------------------------
// Box cotangent and center force of the lane cotangents, shared by the
// radial backward and the two chains.
//
// dh[m][c] -= S_m g_c for a compact lane reading window lane w (dh_add;
// S from the row's window table, lane_shift; a row of an interior bin has
// S = 0 on every lane and skips them). A thread keeps nine partial sums;
// the block adds them by warp shuffles, then over its warps in warp order,
// into one partial per block; dh_reduce_kernel (aev_common.cuh) adds the
// partials in a fixed order.
// ---------------------------------------------------------------------------

// Every thread of the block calls it (it synchronizes the block).
template <typename T>
__device__ __forceinline__ void block_dh_partial(T (&dh)[9], T (*red)[9],
                                                 T* __restrict__ dh_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const T sum = warp_sum(dh[i]);
    if (lane == 0) red[warp][i] = sum;
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    T sum = T(0);
    for (int wi = 0; wi < kWarpsPerBlock; ++wi) sum += red[wi][threadIdx.x];
    dh_part[(size_t)blockIdx.x * 9 + threadIdx.x] = sum;
  }
}

// The row's center force: the sum of its lanes' cotangents.
template <typename T>
__device__ __forceinline__ void store_fcen(T fx, T fy, T fz,
                                           T* __restrict__ fcen, int row,
                                           int lane) {
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  if (lane == 0) {
    fcen[(size_t)row * 3] = fx;
    fcen[(size_t)row * 3 + 1] = fy;
    fcen[(size_t)row * 3 + 2] = fz;
  }
}

// Zeros over a row's three kpad planes, four lanes a thread.
template <typename T>
__device__ __forceinline__ void zero_planes(T* out, int kpad, int lane) {
  const T zero[4] = {T(0), T(0), T(0), T(0)};
  for (int k0 = 4 * lane; k0 < kpad; k0 += 128) {
    st4(out + k0, zero);
    st4(out + kpad + k0, zero);
    st4(out + 2 * kpad + k0, zero);
  }
}

// ---------------------------------------------------------------------------
// Radial and repulsion backward on the compact lanes: one body
// (aev_asn.py `_radial_gamma_core` :776), two kernels.
//
// g[row, c, k] = gamma (a_c / d) of compact lane k, with
//   gamma = sum_kk ga[row, col0[si] + kk] 0.25 e_kk (dfc - 2 eta x_kk fc)
//           + ga[row, srl] d(rep_half)/dd
// for lane k of section si: the derivative of the forward's rad with
// respect to a = center - candidate. Dead lanes and the lanes above the
// sections give exactly 0, and so does every lane of a row with no atom
// (sp < 0; build_inv keeps no lane of an empty slot).
//   asn_radial_gamma_kernel    g alone — replaces aev_asn.py:850
//                              _radial_gamma_only_kernel;
//   asn_radial_bwd_asn_kernel  g, the center force fcen[row] (the sum over
//                              the row's lanes) and the box cotangent dh —
//                              replaces aev_asn.py:816
//                              _radial_bwd_asn_kernel.
// Bound: writing the three [NC, cap, kpad] planes (bytes) against the fp32
// instructions and special-function results of the lanes (chip_smoke
// ASN_OPS: per assigned lane, per lane within Rcr, per repulsion lane);
// bytes bound it at the MD state.
// Design: one warp per row, three passes through the warp's shared memory.
// Pass 1 finds the row's 27 window bins once (window_tab), takes every
// compact lane's geometry through them (lane_geometry_tab, the step
// forward's), keeps (dx, dy, dz, dist) at the lane's index and appends the
// lanes within Rcr or the repulsion cutoff to a packed list by ballot, in
// ascending lane order (about 30 of a row's 81 assigned lanes at the MD
// state). Pass 2 runs the 16 shifts and the repulsion slope over the
// packed list on full warps (f32: the forward's ex2 Gaussians, gauss_of,
// and the hardware cosine and sine) and leaves each lane's gamma at its
// index. The f32 Gaussians are the forward's own, but fc and dfc are not:
// step_row keeps the accurate cosine, so they differ from the forward's fc
// by the hardware cosine's error (within the f32 gate; f64 is unchanged).
// Pass 3 writes the planes four lanes a thread in 16-byte stores, gamma /
// d by quot<true>. One thread computes a lane's gamma, so the packing
// order does not change it; f64 evaluates the plain expressions in their
// order. A row with no atom writes its zeros and reads nothing else: this
// equals the plain version only where such a row has no live lane in idx
// (build_idx gives it none).
// ---------------------------------------------------------------------------

// A row's shared memory, in bytes: dx, dy, dz, dist and gamma of its kpad
// lanes, its srl + 1 cotangents (rounded up to 4) and the packed list
// (kpad ints); each part a multiple of 16 bytes (kpad % 32 == 0).
__host__ __device__ inline size_t gamma_warp_bytes(int kpad, int srl,
                                                   size_t tsize) {
  return (5 * (size_t)kpad + (size_t)((srl + 4) & ~3)) * tsize +
         4 * (size_t)kpad;
}

template <typename T, bool SUMS>
__device__ __forceinline__ void radial_gamma_row(
    const StepParams<T>& p, const T* __restrict__ pos,
    const int* __restrict__ sp, const T* __restrict__ hmat,
    const int16_t* __restrict__ idx, const T* __restrict__ ga,
    unsigned char* buf, T* __restrict__ gr, int row, int lane, T& fx, T& fy,
    T& fz, T (&dh)[9]) {
  const Grid& g = p.g;
  const int kpad = p.kpad;
  T* out = gr + (size_t)row * 3 * kpad;
  const int csp = sp[row];
  if (csp < 0) {
    zero_planes(out, kpad, lane);
    return;
  }
  T* sdx = reinterpret_cast<T*>(buf);
  T* sdy = sdx + kpad;
  T* sdz = sdy + kpad;
  T* sdist = sdz + kpad;
  T* sgam = sdist + kpad;
  T* gas = sgam + kpad;
  int* plist = reinterpret_cast<int*>(gas + ((p.srl + 4) & ~3));
  T h[9];
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  const int cell = row / g.cap;
  const T cx = pos[row * 3], cy = pos[row * 3 + 1], cz = pos[row * 3 + 2];
  const T* garow = ga + (size_t)row * (p.srl + 1);
  for (int i = lane; i <= p.srl; i += 32) gas[i] = garow[i];
  const WindowTab tab = window_tab(g, cell, lane);
  T a_i, z_i;
  center_rep(p, csp, a_i, z_i);
  // lane s < sec.n: section s's repulsion pair parameters and first column
  T a_sec = T(0), z_sec = T(0);
  int c0_sec = 0, k_total = 0;
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (s < p.sec.n) {
      k_total = p.sec.off[s] + p.sec.k[s];
      if (s == lane) {
        section_rep(p, s, a_i, z_i, a_sec, z_sec);
        c0_sec = p.col0[s];
      }
    }
  }
  const int16_t* irow = idx + (size_t)row * kpad;
  const unsigned below = (1u << lane) - 1u;

  // pass 1: geometry; the packed list of the lanes within a cutoff
  int n_in = 0;
  for (int base = 0; base < k_total; base += 32) {
    const int k = base + lane;
    const bool in_sec = k < k_total;
    const int w = in_sec ? (int)irow[k] : p.wpad;
    const LaneGeom<T> lg =
        lane_geometry_tab(g, tab, pos, h, cx, cy, cz, w, p.wpad);
    int si = 0;
#pragma unroll
    for (int s = 1; s < kMaxS; ++s)
      if (s < p.sec.n && k >= p.sec.off[s]) si = s;
    const T z_ij = __shfl_sync(kFull, z_sec, si);
    const bool m = lg.valid && (lg.dist <= p.rc ||
                                (p.has_rep && z_ij > T(0) &&
                                 lg.dist < p.rep_rc));
    if (in_sec) {
      sdx[k] = lg.dx;
      sdy[k] = lg.dy;
      sdz[k] = lg.dz;
      sdist[k] = lg.dist;
      sgam[k] = T(0);
    }
    const unsigned bal = __ballot_sync(kFull, m);
    if (m) plist[n_in + __popc(bal & below)] = k | si << 16;
    n_in += __popc(bal);
  }
  __syncwarp();

  // pass 2: gamma of the packed lanes, 32 at a time
  const T g_rep = gas[p.srl];
  const T two_eta = T(2) * p.eta;
  for (int base = 0; base < n_in; base += 32) {
    const int j = base + lane;
    const int ent = j < n_in ? plist[j] : 0;
    const int k = ent & 0xffff, si = ent >> 16;
    const int c0 = __shfl_sync(kFull, c0_sec, si);
    const T a_ij = __shfl_sync(kFull, a_sec, si);
    const T z_ij = __shfl_sync(kFull, z_sec, si);
    if (j < n_in) {
      const T dist = sdist[k];
      T gamma = T(0);
      if (dist <= p.rc) {
        const T arg = dist * p.pi_rc;
        const T fc = T(0.5) * cos_0pi(arg) + T(0.5);
        const T dfc = p.dfc_rk * sin_0pi(arg);
        const T x = dist - p.mu0;
        const T* gsec = gas + c0;
#pragma unroll
        for (int kk = 0; kk < kMaxNR; ++kk) {
          if (kk < p.NR) {
            const T xk = x - T(kk) * p.delta;
            T e = gauss_of(p.geta * xk * xk);
            e = e > p.tiny_e ? e : T(0);
            gamma += gsec[kk] * (T(0.25) * e * (dfc - two_eta * xk * fc));
          }
        }
      }
      if (p.has_rep && z_ij > T(0) && dist < p.rep_rc)
        gamma += g_rep * rep_half_grad(p, dist, a_ij, z_ij);
      sgam[k] = gamma;
    }
  }
  __syncwarp();

  // pass 3: the planes, four lanes a thread
  const bool interior = SUMS && bin_interior(g, cell);
  for (int base = 0; base < kpad; base += 128) {
    const int k0 = base + 4 * lane;
    const bool in = k0 < kpad;
    // 16-byte shared loads (a lane's four values at a time; lanes at or
    // above k_total are never written and never used)
    T ax[4] = {}, ay[4] = {}, az[4] = {}, d[4] = {}, gam[4] = {};
    if (in) {
      ld4(sdx + k0, ax);
      ld4(sdy + k0, ay);
      ld4(sdz + k0, az);
      ld4(sdist + k0, d);
      ld4(sgam + k0, gam);
    }
    T gx[4], gy[4], gz[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gx[j] = gy[j] = gz[j] = T(0);
      if (k0 + j < k_total) {
        const T gd = quot<true>(gam[j], d[j]);
        gx[j] = gd * ax[j];
        gy[j] = gd * ay[j];
        gz[j] = gd * az[j];
      }
    }
    if (in) {
      st4(out + k0, gx);
      st4(out + kpad + k0, gy);
      st4(out + 2 * kpad + k0, gz);
    }
    if constexpr (SUMS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fx += gx[j];
        fy += gy[j];
        fz += gz[j];
      }
      if (!interior) {
        int w[4] = {p.wpad, p.wpad, p.wpad, p.wpad};
        if (in) ld4(irow + k0, w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dh_add(lane_shift(g, tab, w[j]), gx[j], gy[j], gz[j], dh);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_radial_gamma_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const int16_t* __restrict__ idx,
    const T* __restrict__ ga, T* __restrict__ gr, StepParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= p.g.nx * p.g.ny * p.g.nz * p.g.cap) return;
  T fx = T(0), fy = T(0), fz = T(0), dh[9];
  radial_gamma_row<T, false>(
      p, pos, sp, hmat, idx, ga,
      smem_raw + warp * gamma_warp_bytes(p.kpad, p.srl, sizeof(T)), gr, row,
      lane, fx, fy, fz, dh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_radial_bwd_asn_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const int16_t* __restrict__ idx,
    const T* __restrict__ ga, T* __restrict__ gr, T* __restrict__ fcen,
    T* __restrict__ dh_part, StepParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kWarpsPerBlock][9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  T dh[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dh[i] = T(0);
  if (row < p.g.nx * p.g.ny * p.g.nz * p.g.cap) {
    T fx = T(0), fy = T(0), fz = T(0);
    radial_gamma_row<T, true>(
        p, pos, sp, hmat, idx, ga,
        smem_raw + warp * gamma_warp_bytes(p.kpad, p.srl, sizeof(T)), gr,
        row, lane, fx, fy, fz, dh);
    store_fcen(fx, fy, fz, fcen, row, lane);
  }
  block_dh_partial(dh, red, dh_part);
}

// ---------------------------------------------------------------------------
// Packed angular pairs — replaces aev_asn.py:1794 _packed_fwd_kernel and
// aev_asn.py:1833 _packed_bwd_kernel.
//
// Rows: cat [rows, 5 atot], the packed slots' fields (ux, uy, uz, d, fc)
// field after field. Block b pairs the slots of two arms, [off1, off1 +
// a1) and [off2, off2 + a2), the first a_t slots of two sections at a
// tier's caps (one species: the strict upper triangle of slot pairs;
// cross species: the rectangle; each unordered pair once, at scale 2).
// Forward: out [rows, n_blocks * 32], the sum over block b's pairs of
//   2 fc1 fc2 exp(-eta (rmean - shf_a_j)^2) ((1 + cos(theta - shf_z_m))/2)^zeta
// in column b*32 + j*8 + m. Backward: for the cotangent ga of those
// columns, out [rows, 5 atot], each slot's cotangent sums of (ux, uy, uz,
// d, fc) over both arms of every pair (the radial-mean term only where
// d1 + d2 <= 2 (Rca + 1)).
// Stage 2 fills a section's slots from its start and parks the rest (u =
// 0, d = big = 2 Rca + 10, fc = 0, as the tier pad rows are), so an arm is
// a live prefix of n <= a slots and parked slots after it. A pair with a
// parked slot has fc12 = 0: it adds exactly 0 to the forward's columns
// and to its live slot's cotangent sums, and gives its parked slot an fc
// cotangent only, dfc12 fc_live, where dfc12 = C_b is the same for every
// such pair of a block and row (its cosine is 0 and its radial mean is
// clamped to Rca + 1). So both kernels find each arm's live prefix (one
// past the last slot that is not parked, by ballot) and walk the live
// pairs only, enumerated from their index (the triangle by a float square
// root and an integer correction): the host lane table of the contract is
// not read. A slot filled at distance <= 1e-6 has d = big too, but u != 0
// unless the offset is exactly 0; it counts as live and its pairs are
// computed (they give exact zeros as well). One launch per occupancy tier;
// one warp per row stages the row's 5 atot fields in shared memory.
//
// Powers: base^zeta with zeta = 14.1 (ANI-2x) is most of a pair's
// arithmetic. In f32 with a zeta that is not an integer it is
// base^n 2^(f log2 base), n = floor(zeta), f = zeta - n (zeta_pow_split),
// and the backward's chain rule divides by __fdividef; f64, and an integer
// zeta, keep zeta_pow (aev_common.cuh) and the IEEE division.
//
// Bound (chip_smoke.py ASN_OPS): per filled pair, fp32 instructions (an
// fma counts once) over the card's instruction rate and special-function
// results (the 8 powers' lg2 and ex2, the 4 radial shifts' ex2, the
// square root) over its special-function rate, against the bytes of the
// rows. Design, forward: each lane takes every 32nd live pair of a block
// and keeps the 32 column sums in registers; a reduce-scatter of 31
// shuffles leaves column l on lane l, which writes it (coalesced).
// Backward, per block: lane l loads cotangent column l once into shared
// memory, where every lane reads the 32; pass 1 gives every live pair to a
// lane, which leaves the pair's three scalars (dcos, drmean / 2, dfc12) in
// shared memory, and one more lane computes C_b where a parked slot has a
// live partner; pass 2 gives every slot of the block's arms to one lane: a
// live slot walks its live partners in index order with a running pair
// index (5 multiply-adds per partner; every lane of a block takes as many
// steps), a parked slot takes C_b times the fc sum of the live slots it
// pairs with (one warp sum per arm). Every slot is written by one lane and
// every sum has a fixed order: no atomics, two calls agree bit for bit.
// Slots in no arm of any block get 0. A row with every slot parked gives
// zeros.
// ---------------------------------------------------------------------------
template <typename T>
struct PackedParams : AngConsts<T> {
  int rows, atot, n_blocks;
  // the blocks' arms: packed slot offsets and widths, same-species flag
  int off1[kMaxBlocks], off2[kMaxBlocks], a1[kMaxBlocks], a2[kMaxBlocks];
  int same[kMaxBlocks];
  int max_q;       // the largest block's pair count
  int zeta_floor;  // floor(zeta)
  T pmin;
  T zeta_frac;     // zeta - floor(zeta)
  T big;           // a parked slot's d, 2 Rca + 10
};

// Pair terms of the staged slots i1, i2 of a row (s: [5][A]); P carries
// zeta_floor and zeta_frac (PackedParams, BlockParams).
template <typename T, typename P>
__device__ __forceinline__ void packed_terms(const P& p, const T* s, int A,
                                             int i1, int i2,
                                             PairTerms<T>& pt) {
  pair_terms_geom<T>(p, s[i1], s[A + i1], s[2 * A + i1], s[i2], s[A + i2],
                     s[2 * A + i2], s[3 * A + i1], s[3 * A + i2],
                     s[4 * A + i1], s[4 * A + i2], pt);
  pair_powers<T>(p, pt);
}

// One past the last slot of [off, off + a) that is not parked: the arm's
// live prefix. Uniform over the warp; every lane calls it.
template <typename T>
__device__ __forceinline__ int live_len(const T* s, int A, int off, int a,
                                        T big, int lane) {
  int n = 0;
  for (int c = 0; c < a; c += 32) {
    const int i = off + c + lane;
    const bool live = c + lane < a &&
                      !(s[i] == T(0) && s[A + i] == T(0) &&
                        s[2 * A + i] == T(0) && s[3 * A + i] == big &&
                        s[4 * A + i] == T(0));
    const unsigned bal = __ballot_sync(kFull, live);
    if (bal) n = c + 32 - __clz(bal);
  }
  return n;
}

// Slot pair (j, k) of live pair t of a block with live prefixes n1, n2:
// the triangle row by row for one species, else the rectangle.
__device__ __forceinline__ void live_pair(int t, bool same, int n1, int n2,
                                          int& j, int& k) {
  if (same)
    block_pair<kTri>(t, n1, n1, j, k);
  else
    block_pair<kCross>(t, n1, n2, j, k);
}

// Sum of fc over the slots [off, off + n) (the same on every lane).
template <typename T>
__device__ __forceinline__ T arm_fc_sum(const T* s, int A, int off, int n,
                                        int lane) {
  T v = T(0);
  for (int c = 0; c < n; c += 32)
    if (c + lane < n) v += s[4 * A + off + c + lane];
  return warp_sum(v);
}

// The forward's pair pass over one block of a row staged in shared memory
// (s: [5][A], the arms [off1, off1 + a1) and [off2, off2 + a2) of its
// slots): each arm's live prefix by ballot, then each lane takes every
// 32nd live pair (one species: the triangle of the n1 live slots row by
// row; two: the n1 x n2 rectangle) and adds its 32 column terms fc12 e_j
// f1_m into acc[j*8 + m], the lane's partial sums. FLUSH (packed_fwd): a
// term is added only where it exceeds p.pmin; the per-block forwards add
// each term as it comes. P carries big, zeta_floor and zeta_frac
// (PackedParams, BlockParams). Every lane calls it.
template <bool FLUSH, typename T, typename P>
__device__ __forceinline__ void block_pairs_fwd(const P& p, const T* s,
                                                int A, int off1, int a1,
                                                int off2, int a2, bool same,
                                                int lane, T (&acc)[kNAZ]) {
  const int n1 = live_len(s, A, off1, a1, p.big, lane);
  const int n2 = same ? n1 : live_len(s, A, off2, a2, p.big, lane);
  const int q = same ? n1 * (n1 - 1) / 2 : n1 * n2;
#pragma unroll
  for (int i = 0; i < kNAZ; ++i) acc[i] = T(0);
  for (int t = lane; t < q; t += 32) {
    int j, k;
    live_pair(t, same, n1, n2, j, k);
    PairTerms<T> pt;
    packed_terms<T>(p, s, A, off1 + j, off2 + k, pt);
#pragma unroll
    for (int jj = 0; jj < kNA; ++jj) {
      const T f2 = pt.fc12 * pt.e[jj];
#pragma unroll
      for (int m = 0; m < kNZ; ++m) {
        const T c = f2 * pt.f1[m];
        if constexpr (FLUSH)
          acc[jj * kNZ + m] += c > p.pmin ? c : T(0);
        else
          acc[jj * kNZ + m] += c;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_packed_fwd_kernel(
    const T* __restrict__ cat, T* __restrict__ out, PackedParams<T> p) {
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
    block_pairs_fwd<true>(p, s, A, p.off1[b], p.a1[b], p.off2[b], p.a2[b],
                          p.same[b] != 0, lane, acc);
    reduce_scatter32<T>(acc, lane);
    orow[b * kNAZ + lane] = T(2) * acc[0];
  }
}

// The backward's two pair passes over one block of a row staged in shared
// memory (s: [5][A], the arms [off1, off1 + a1) and [off2, off2 + a2) of
// its slots; gsm: the block's 32 column cotangents, scale included; pb:
// [3][Q], Q at least the block's pair count): each slot's five sums go to
// add(slot, g) on one lane (packed_bwd: its row's sums in shared memory;
// the per-block kernels: acc in place). P carries big, zeta_floor and
// zeta_frac (PackedParams, BlockParams). Every lane calls it; it ends with
// the warp synchronized.
template <typename T, typename P, typename Add>
__device__ __forceinline__ void block_pairs_bwd(const P& p, const T* s, int A,
                                                int off1, int a1, int off2,
                                                int a2, bool same,
                                                const T* gsm, T* pb, int Q,
                                                int lane, Add add) {
  const T(&gb)[kNAZ] = *reinterpret_cast<const T(*)[kNAZ]>(gsm);
  const int n1 = live_len(s, A, off1, a1, p.big, lane);
  const int n2 = same ? n1 : live_len(s, A, off2, a2, p.big, lane);
  const int q = same ? n1 * (n1 - 1) / 2 : n1 * n2;
  // C_b is wanted where a parked slot has a live partner; it is pair q
  // (q < Q then: a parked slot leaves a pair of the full block out)
  const bool want_cb = same ? (n1 < a1 && n1 > 0)
                            : ((n1 < a1 && n2 > 0) || (n2 < a2 && n1 > 0));
  const int q_all = q + (want_cb ? 1 : 0);
  for (int t = lane; t < q_all; t += 32) {
    // the parked pair: u = 0 and fc = 0 on both arms, d = big
    T u1x = T(0), u1y = T(0), u1z = T(0), u2x = T(0), u2y = T(0),
      u2z = T(0), d1 = p.big, d2 = p.big, fc1 = T(0), fc2 = T(0);
    if (t < q) {
      int j, k;
      live_pair(t, same, n1, n2, j, k);
      const int i1 = off1 + j, i2 = off2 + k;
      u1x = s[i1];
      u1y = s[A + i1];
      u1z = s[2 * A + i1];
      u2x = s[i2];
      u2y = s[A + i2];
      u2z = s[2 * A + i2];
      d1 = s[3 * A + i1];
      d2 = s[3 * A + i2];
      fc1 = s[4 * A + i1];
      fc2 = s[4 * A + i2];
    }
    PairTerms<T> pt;
    pair_terms_geom<T>(p, u1x, u1y, u1z, u2x, u2y, u2z, d1, d2, fc1, fc2,
                       pt);
    pair_powers<T>(p, pt);
    T dcos, drmean, dfc12;
    pair_cotangents<T, true>(p, pt, gb, dcos, drmean, dfc12);
    pb[t] = dcos;
    pb[Q + t] = T(0.5) * drmean;
    pb[2 * Q + t] = dfc12;
  }
  __syncwarp();
  // a parked slot's fc cotangent: C_b times the fc sum of the live slots
  // of the other arm (its own for one species)
  T c_fc1 = T(0), c_fc2 = T(0);
  if (want_cb) {
    const T c_b = pb[2 * Q + q];
    c_fc1 = c_b * arm_fc_sum(s, A, off1, n1, lane);
    c_fc2 = same ? c_fc1 : c_b * arm_fc_sum(s, A, off2, n2, lane);
  }
  // items: the live slots of arm 1, of arm 2 (cross), then the parked
  // slots of arm 1, of arm 2. A live slot walks its live partners in
  // index order, with a running pair index; every lane of a block's walk
  // takes the same number of steps.
  const int w1 = n1, w2 = same ? 0 : n2;
  const int p1 = a1 - n1, p2 = same ? 0 : a2 - n2;
  for (int it = lane; it < w1 + w2 + p1 + p2; it += 32) {
    T g[5] = {T(0), T(0), T(0), T(0), T(0)};
    int slot;
    if (it < w1 + w2 && same) {
      // pairs (k, j), k < j: index j - 1 at k = 0, then + n1 - 2 - k;
      // pairs (j, k), k > j: consecutive from the row's start
      const int j = it;
      slot = off1 + j;
      int t_lo = j - 1, t_hi = tri_start(j, n1);
      for (int k = 0; k < n1; ++k) {
        if (k == j) continue;
        add_partner<T>(g, pb, Q, k < j ? t_lo : t_hi, s, A, off1 + k);
        if (k < j)
          t_lo += n1 - 2 - k;
        else
          ++t_hi;
      }
    } else if (it < w1 + w2) {
      // arm 1 slot i: pairs i n2 + k; arm 2 slot i: pairs j n2 + i
      const bool arm1 = it < w1;
      const int i = arm1 ? it : it - w1;
      slot = (arm1 ? off1 : off2) + i;
      const int po = arm1 ? off2 : off1, cnt = arm1 ? n2 : n1;
      const int stride = arm1 ? 1 : n2;
      int t = arm1 ? i * n2 : i;
      for (int k = 0; k < cnt; ++k, t += stride)
        add_partner<T>(g, pb, Q, t, s, A, po + k);
    } else {
      const int r = it - w1 - w2;
      const bool arm1 = r < p1;
      slot = arm1 ? off1 + n1 + r : off2 + n2 + (r - p1);
      g[4] = arm1 ? c_fc2 : c_fc1;
    }
    add(slot, g);
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_packed_bwd_kernel(
    const T* __restrict__ cat, const T* __restrict__ ga, T* __restrict__ out,
    PackedParams<T> p, int warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int A = p.atot, Q = p.max_q;
  T* s = reinterpret_cast<T*>(smem_raw) +
         (size_t)warp * (10 * A + 3 * Q + kNAZ);
  T* o = s + 5 * A;    // the slots' sums, [5][A]
  T* pb = o + 5 * A;   // the block's pair scalars, [3][Q]
  T* gsm = pb + 3 * Q; // the block's column cotangents, [32]
  const int row = blockIdx.x * warps + warp;
  if (row >= p.rows) return;
  const T* in = cat + (size_t)row * 5 * A;
  for (int i = lane; i < 5 * A; i += 32) {
    s[i] = in[i];
    o[i] = T(0);
  }
  __syncwarp();
  const T* g_row = ga + (size_t)row * p.n_blocks * kNAZ;
  for (int b = 0; b < p.n_blocks; ++b) {
    // the block's 32 column cotangents, one load a lane, read by every
    // lane from shared memory (in registers they cost the kernel a third
    // of its occupancy)
    gsm[lane] = T(2) * g_row[b * kNAZ + lane];
    __syncwarp();
    block_pairs_bwd(p, s, A, p.off1[b], p.a1[b], p.off2[b], p.a2[b],
                    p.same[b] != 0, gsm, pb, Q, lane,
                    [&](int slot, const T(&g)[5]) {
#pragma unroll
                      for (int f = 0; f < 5; ++f) o[f * A + slot] += g[f];
                    });
  }
  T* orow = out + (size_t)row * 5 * A;
  for (int i = lane; i < 5 * A; i += 32) orow[i] = o[i];
}

// ---------------------------------------------------------------------------
// Per-block angular pairs (the JAX package's LAT_ANG_PACKED=0 stage): one
// launch per species-pair block per occupancy tier, on the flat rows
// cat [rows, 5 atot] (fields ux, uy, uz, d, fc). A block's arms are slots
// [off1, off1 + a1) and [off2, off2 + a2) of a row: the first a_t slots of
// each section (a tier's caps). Three forms of a block:
//   cross   two species, every (arm-1, arm-2) slot pair at scale 2;
//   full    one species, every ordered pair (j, k), j != k, at scale 1 (the
//           TPU kernel masks the diagonal, whose terms are all 0: skipping
//           it is exact up to the sign of zero);
//   tri     one species, the strict upper triangle at scale 2.
//   asn_block_fwd_kernel      cross and full — replaces aev_asn.py:1291
//                             _block_fwd_kernel: out [rows, 32], column
//                             j*8 + m, each pair's terms summed as they come
//                             (no flush of tiny products);
//   asn_block_fwd_tri_kernel  tri — replaces aev_asn.py:1503
//                             _block_fwd_tri_kernel;
//   asn_block_bwd_kernel      cross and full — replaces aev_asn.py:1328
//                             _block_bwd_kernel: for the cotangent ga
//                             [rows, 32] of the block's columns, each arm
//                             slot's cotangent sums of (ux, uy, uz, d, fc)
//                             (the radial-mean term only where d1 + d2 <=
//                             2 (Rca + 1)), added in place into acc [rows,
//                             5 atot]; a same-species slot takes its arm-1
//                             sum plus its arm-2 sum;
//   asn_block_bwd_tri_kernel  tri — replaces aev_asn.py:1519
//                             _block_bwd_tri_kernel.
// The TPU kernels cut a block into 128-lane chunks (one grid step or one
// call each) because a vreg holds 128 lanes; here one launch covers the
// block whole. Bound: operations (the packed kernels' pair terms, on the
// pairs of one block) against reading the block's slot fields and writing
// 32 columns (forward) or reading the columns' cotangent and adding to the
// block's slots (backward): bytes. Design: one warp per row stages the
// block's slots in shared memory. Forward, the packed forward's own pair
// pass (block_pairs_fwd) without its flush of tiny terms: each arm's live
// prefix by ballot, each lane every 32nd live pair (parked slots add
// exactly 0 and are never walked; a row with every slot parked writes
// zeros) with the f32 split power, the 32 sums in registers, and a
// reduce-scatter leaves column l on lane l. Backward, the packed
// backward's own per-block passes (block_pairs_bwd): each arm's live prefix
// by ballot, pass 1 over the live pairs only (the f32 split power and fast
// divisions) with C_b on one more lane, pass 2 a live slot a lane walking
// its live partners in index order with a running pair index and a parked
// slot taking C_b times the live fc sum of the arm it pairs with. Both
// go through the triangle at scale 2 for the full form: its pairs (j, k)
// and (k, j) have the same terms, bit for bit, so each unordered pair is
// evaluated once. Fixed order, no atomics, so two calls agree bit for bit;
// successive launches on one stream add into acc in turn.
// ---------------------------------------------------------------------------
template <typename T>
struct BlockParams : AngConsts<T> {
  int rows, atot;
  int off1, a1, off2, a2;  // the arms' first slots and widths
  int same;                // one species: off2 = off1, a2 = a1
  int q;                   // pairs per row of the form launched
  int zeta_floor;          // floor(zeta), for the f32 split power
  T zeta_frac;             // zeta - floor(zeta)
  T big;                   // a parked slot's d, 2 Rca + 10
};

// The block's slots of one row into shared memory as one row of A = a1
// (one species) or a1 + a2 slots, field after field (arm 1 from 0, arm 2
// from a1). Returns A.
template <typename T>
__device__ __forceinline__ int stage_arms(const T* __restrict__ cat, T* s,
                                          const BlockParams<T>& p, bool same,
                                          int row, int lane) {
  const int A = same ? p.a1 : p.a1 + p.a2;
  const T* in = cat + (size_t)row * 5 * p.atot;
  for (int j = lane; j < A; j += 32) {
    const int at = j < p.a1 ? p.off1 + j : p.off2 + j - p.a1;
#pragma unroll
    for (int f = 0; f < 5; ++f) s[f * A + j] = in[f * p.atot + at];
  }
  return A;
}

// One row of a per-block forward: the block's slots staged (stage_arms),
// then packed_fwd's own pair pass (block_pairs_fwd) without the flush:
// the live pairs only, each unordered pair once at scale 2 (the full
// form's two orders have the same terms), the 32 sums reduce-scattered,
// lane l writing column l.
template <typename T>
__device__ __forceinline__ void block_fwd_row(const T* __restrict__ cat,
                                              T* __restrict__ out, T* s,
                                              const BlockParams<T>& p,
                                              bool same, int row, int lane) {
  const int A = stage_arms(cat, s, p, same, row, lane);
  __syncwarp();
  T acc[kNAZ];
  block_pairs_fwd<false>(p, s, A, 0, p.a1, same ? 0 : p.a1,
                         same ? p.a1 : p.a2, same, lane, acc);
  reduce_scatter32<T>(acc, lane);
  out[(size_t)row * kNAZ + lane] = T(2) * acc[0];
}

// One row of a per-block backward: the block's slots staged (stage_arms),
// then their pair scalars [3][q] and the 32 column cotangents at scale 2
// (each unordered pair once: cross and tri at their own scale, the full
// form's two orders at scale 1 each); the slots' sums added into acc.
template <typename T>
__device__ __forceinline__ void block_bwd_row(const T* __restrict__ cat,
                                              const T* __restrict__ ga,
                                              T* __restrict__ acc, T* s,
                                              const BlockParams<T>& p,
                                              bool same, int row, int lane) {
  const int A = stage_arms(cat, s, p, same, row, lane), Q = p.q;
  T* pb = s + 5 * A;
  T* gsm = pb + 3 * Q;
  gsm[lane] = T(2) * ga[(size_t)row * kNAZ + lane];
  __syncwarp();
  T* orow = acc + (size_t)row * 5 * p.atot;
  block_pairs_bwd(p, s, A, 0, p.a1, same ? 0 : p.a1, same ? p.a1 : p.a2,
                  same, gsm, pb, Q, lane, [&](int slot, const T(&g)[5]) {
                    const int at =
                        slot < p.a1 ? p.off1 + slot : p.off2 + slot - p.a1;
#pragma unroll
                    for (int f = 0; f < 5; ++f) orow[f * p.atot + at] += g[f];
                  });
}

// The per-block forwards' blocks: kFwdWarps rows, at least kFwdMinBlocks
// blocks an SM (with the thread bound alone ptxas held them at 80
// registers and spilled to local memory).
constexpr int kFwdWarps = 2, kFwdMinBlocks = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kFwdWarps, kFwdMinBlocks)
    asn_block_fwd_kernel(const T* __restrict__ cat, T* __restrict__ out,
                         BlockParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* s = reinterpret_cast<T*>(smem_raw) +
         warp * 5 * (p.same ? p.a1 : p.a1 + p.a2);
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= p.rows) return;
  block_fwd_row<T>(cat, out, s, p, p.same != 0, row, lane);
}

template <typename T>
__global__ void __launch_bounds__(32 * kFwdWarps, kFwdMinBlocks)
    asn_block_fwd_tri_kernel(const T* __restrict__ cat, T* __restrict__ out,
                             BlockParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* s = reinterpret_cast<T*>(smem_raw) + warp * 5 * p.a1;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= p.rows) return;
  // p.same is 1 here; read at run time, as the backwards read it
  block_fwd_row<T>(cat, out, s, p, p.same != 0, row, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_block_bwd_kernel(
    const T* __restrict__ cat, const T* __restrict__ ga, T* __restrict__ acc,
    BlockParams<T> p, int warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* s = reinterpret_cast<T*>(smem_raw) +
         (size_t)warp * (5 * (p.same ? p.a1 : p.a1 + p.a2) + 3 * p.q + kNAZ);
  const int row = blockIdx.x * warps + warp;
  if (row >= p.rows) return;
  block_bwd_row<T>(cat, ga, acc, s, p, p.same != 0, row, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_block_bwd_tri_kernel(
    const T* __restrict__ cat, const T* __restrict__ ga, T* __restrict__ acc,
    BlockParams<T> p, int warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* s = reinterpret_cast<T*>(smem_raw) +
         (size_t)warp * (5 * p.a1 + 3 * p.q + kNAZ);
  const int row = blockIdx.x * warps + warp;
  if (row >= p.rows) return;
  // p.same is 1 here; read at run time, it gives both kernels one body
  // (a constant let ptxas spill)
  block_bwd_row<T>(cat, ga, acc, s, p, p.same != 0, row, lane);
}

// ---------------------------------------------------------------------------
// Slot cotangents -> compact lanes: one body (aev_asn.py `_chain_to_stage1`
// :1975), two kernels.
//
// Per row: the packed slots' cotangents gsum [5][atot] (of ux, uy, uz, d,
// fc) become vector cotangents (slots with d < Rca + 5 only:
// g_cd = gd + gfc dfc - (gu . u) / d, g = gu / d + g_cd u); compact lane k
// takes the vector of its slot rank2[k] (no slot: 0): gt [row][3][kpad].
// fcen[row] = the sum over lanes; dh as block_dh_partial above.
//   asn_chain_sum_kernel        adds the radial part gr[., k] to every lane
//                               first — replaces aev_asn.py:2047
//                               _chain_sum_kernel;
//   asn_decompact_chain_kernel  the slot chain alone (gr is neither read
//                               nor passed) — replaces aev_asn.py:2013
//                               _decompact_chain_kernel.
// Bound: writing gt (and reading gr), three [NC, cap, kpad] planes each
// (bytes). Design: one warp per row. It reads the row's idx first, four
// lanes a thread in 8-byte loads: a row with no live lane (every row
// without an atom) writes zeros and reads nothing else. That equals the
// plain chain only where gr is 0 on a dead lane (radial_gamma writes it
// so) and no dead lane has a slot (compact_asn's rank2). Otherwise the
// slot vectors go to shared memory (f32: 1 / d by quot<true>), and each
// thread takes four consecutive compact lanes of each 128: rank2 and idx
// in one 8-byte load each, gr in three 16-byte loads, the gather through
// rank2 from shared memory, gt in three 16-byte stores (kpad 128: one pass
// a row). fcen is a warp shuffle sum; a row of an interior bin adds
// nothing to dh, any other takes its lanes' shifts from the row's window
// table.
// ---------------------------------------------------------------------------

template <typename T, bool ADD_RADIAL>
__device__ __forceinline__ void chain_row(
    const int16_t* __restrict__ rank2, const int16_t* __restrict__ idx,
    const T* __restrict__ cmp, const T* __restrict__ gsum,
    const T* __restrict__ gr, T* __restrict__ gt, T* __restrict__ fcen, T* v,
    const Grid& g, int kpad, int A, T d_live, int row, int lane,
    T (&dh)[9]) {
  const int W = 27 * g.cap;  // idx >= W: a dead lane
  const int16_t* irow = idx + (size_t)row * kpad;
  T* orow = gt + (size_t)row * 3 * kpad;
  bool live = false;
  for (int k0 = 4 * lane; k0 < kpad; k0 += 128) {
    int w[4];
    ld4(irow + k0, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) live |= w[j] < W;
  }
  if (!__any_sync(kFull, live)) {
    zero_planes(orow, kpad, lane);
    if (lane < 3) fcen[(size_t)row * 3 + lane] = T(0);
    return;
  }
  const T* c = cmp + (size_t)row * 6 * A;
  const T* gs = gsum + (size_t)row * 5 * A;
  for (int a = lane; a < A; a += 32) {
    const T ux = c[a], uy = c[A + a], uz = c[2 * A + a];
    const T d = c[3 * A + a], dfc = c[5 * A + a];
    const T gux = gs[a], guy = gs[A + a], guz = gs[2 * A + a];
    const bool slot_live = d < d_live;
    const T inv_d = slot_live ? quot<true>(T(1), d) : T(0);
    const T dot = gux * ux + guy * uy + guz * uz;
    const T g_cd =
        slot_live ? gs[3 * A + a] + gs[4 * A + a] * dfc - dot * inv_d : T(0);
    v[a] = gux * inv_d + g_cd * ux;
    v[(kDeadSlot + 1) + a] = guy * inv_d + g_cd * uy;
    v[2 * (kDeadSlot + 1) + a] = guz * inv_d + g_cd * uz;
  }
  __syncwarp();
  const int cell = row / g.cap;
  const bool interior = bin_interior(g, cell);
  WindowTab tab{0, 0};
  if (!interior) tab = window_tab(g, cell, lane);
  const int16_t* r2row = rank2 + (size_t)row * kpad;
  const T* grow = ADD_RADIAL ? gr + (size_t)row * 3 * kpad : nullptr;
  T fx = T(0), fy = T(0), fz = T(0);
  for (int base = 0; base < kpad; base += 128) {
    const int k0 = base + 4 * lane;
    const bool in = k0 < kpad;
    int r[4] = {kDeadSlot, kDeadSlot, kDeadSlot, kDeadSlot};
    int w[4] = {W, W, W, W};
    T gx[4] = {T(0), T(0), T(0), T(0)};
    T gy[4] = {T(0), T(0), T(0), T(0)};
    T gz[4] = {T(0), T(0), T(0), T(0)};
    if (in) {
      ld4(r2row + k0, r);
      if (!interior) ld4(irow + k0, w);
      if constexpr (ADD_RADIAL) {
        ld4(grow + k0, gx);
        ld4(grow + kpad + k0, gy);
        ld4(grow + 2 * kpad + k0, gz);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r[j] >= 0 && r[j] < A) {
        gx[j] += v[r[j]];
        gy[j] += v[(kDeadSlot + 1) + r[j]];
        gz[j] += v[2 * (kDeadSlot + 1) + r[j]];
      }
      fx += gx[j];
      fy += gy[j];
      fz += gz[j];
    }
    if (in) {
      st4(orow + k0, gx);
      st4(orow + kpad + k0, gy);
      st4(orow + 2 * kpad + k0, gz);
    }
    if (!interior) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dh_add(lane_shift(g, tab, w[j]), gx[j], gy[j], gz[j], dh);
    }
  }
  store_fcen(fx, fy, fz, fcen, row, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_chain_sum_kernel(
    const int16_t* __restrict__ rank2, const int16_t* __restrict__ idx,
    const T* __restrict__ cmp, const T* __restrict__ gsum,
    const T* __restrict__ gr, T* __restrict__ gt, T* __restrict__ fcen,
    T* __restrict__ dh_part, Grid g, int kpad, int A, T d_live) {
  __shared__ T gv[kWarpsPerBlock][3 * (kDeadSlot + 1)];
  __shared__ T red[kWarpsPerBlock][9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  T dh[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dh[i] = T(0);
  if (row < g.nx * g.ny * g.nz * g.cap)
    chain_row<T, true>(rank2, idx, cmp, gsum, gr, gt, fcen, gv[warp], g, kpad,
                       A, d_live, row, lane, dh);
  block_dh_partial(dh, red, dh_part);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) asn_decompact_chain_kernel(
    const int16_t* __restrict__ rank2, const int16_t* __restrict__ idx,
    const T* __restrict__ cmp, const T* __restrict__ gsum,
    T* __restrict__ gt, T* __restrict__ fcen, T* __restrict__ dh_part, Grid g,
    int kpad, int A, T d_live) {
  __shared__ T gv[kWarpsPerBlock][3 * (kDeadSlot + 1)];
  __shared__ T red[kWarpsPerBlock][9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  T dh[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dh[i] = T(0);
  if (row < g.nx * g.ny * g.nz * g.cap)
    chain_row<T, false>(rank2, idx, cmp, gsum, nullptr, gt, fcen, gv[warp], g,
                        kpad, A, d_live, row, lane, dh);
  block_dh_partial(dh, red, dh_part);
}

// ---------------------------------------------------------------------------
// Neighbor-role force on the window lanes — replaces aev_asn.py:2083
// _wing_kernel.
//
// wing[bin, w, c] = -sum over the bin's slots, in ascending order, of
// gt[slot, c, k] over the compact lanes k that read window lane w
// (idx[slot, k] == w; a dead lane has idx == wpad), for the 27 cap window
// lanes w. The TPU kernel gathers the same sum through inv, -sum over
// slots of gt[slot, c, inv[slot, w]], where a lane no section keeps names
// compact lane kpad - 1, whose gt is always 0. Where build_inv reported no
// overflow, inv and idx are inverses on the live lanes, so the scatter
// adds the gather's addends in the gather's order less its exact zeros
// (x + 0 is x, and +0 + +-0 is +0): the two agree bit for bit. Where a
// section overflowed, build_inv ranks lanes past the section's k_s, inv
// names one compact lane from two window lanes and idx keeps one of them,
// so the two differ; the MD engine takes no step at such a rebuild
// (Simulation._chunk returns before stepping and regrows the sections).
// Bound: reading gt and idx and writing the wing (bytes). inv is not read.
// Design: one block per bin. Its idx rows come into shared memory by
// cp.async, then the 16-byte groups of its gt rows that hold a live lane
// (the other groups are never read), then, slot after slot with a barrier
// between slots, each thread adds gt[slot, c, k] into the shared
// accumulator [w][c] of window lane w = idx[slot, k]. idx names each
// window lane at most once in a slot (build_idx writes one compact lane
// per window lane), so the adds of a slot never collide and every
// accumulator takes its addends in ascending slot order; a slot without a
// live lane is skipped. The negated sums leave coalesced. Where a bin's
// rows do not fit one block's shared memory (f64, wide kpad), they come
// `batch` slots at a time.
// ---------------------------------------------------------------------------
// The wing's launch, chosen on an H100 at the 101,250-atom box (cap 36):
// 256 threads and 12 slots a batch took 0.142-0.144 ms a call, 9 slots
// 0.139-0.142, a bin's 36 slots at once (3 blocks an SM) 0.173, 128
// threads 0.147-0.149, 384 threads 0.154-0.156.
constexpr int kWingThreads = 256;
constexpr int kWingBatch = 12;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of one wing block: the accumulators [27 cap][3], then
// `batch` slots' idx rows, gt rows and live flags (16-byte aligned parts).
struct WingSmem {
  size_t idx_off, gt_off, flag_off, total;
};

__host__ __device__ inline size_t up16(size_t b) { return (b + 15) / 16 * 16; }

template <typename T>
__host__ __device__ inline WingSmem wing_smem(int cap, int kpad, int batch) {
  WingSmem m;
  m.idx_off = up16(sizeof(T) * 3 * 27 * (size_t)cap);
  m.gt_off = m.idx_off + up16(2 * (size_t)batch * kpad);
  m.flag_off = m.gt_off + sizeof(T) * 3 * (size_t)batch * kpad;
  m.total = m.flag_off + sizeof(int) * (size_t)batch;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kWingThreads) asn_wing_kernel(
    const T* __restrict__ gt, const int16_t* __restrict__ idx,
    T* __restrict__ wing, int cap, int kpad, int batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WingSmem m = wing_smem<T>(cap, kpad, batch);
  T* acc = reinterpret_cast<T*>(smem_raw);                      // [W][3]
  int16_t* sidx = reinterpret_cast<int16_t*>(smem_raw + m.idx_off);
  T* sgt = reinterpret_cast<T*>(smem_raw + m.gt_off);           // [b][3][kpad]
  int* live = reinterpret_cast<int*>(smem_raw + m.flag_off);    // [b]
  constexpr int kVec = 16 / sizeof(T);  // gt lanes per 16-byte copy
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = 27 * cap, bin = blockIdx.x;
  const int gpr = 3 * kpad / kVec;  // 16-byte groups per gt row
  for (int i = tid; i < 3 * W; i += nt) acc[i] = T(0);
  for (int s0 = 0; s0 < cap; s0 += batch) {
    const int nb = cap - s0 < batch ? cap - s0 : batch;
    const size_t row0 = (size_t)bin * cap + s0;
    const int16_t* gidx = idx + row0 * kpad;
    for (int i = tid; i < nb * kpad / 8; i += nt)
      cp_async16(sidx + 8 * i, gidx + 8 * i);
    for (int i = tid; i < nb; i += nt) live[i] = 0;
    cp_async_wait_all();
    __syncthreads();
    const T* ggt = gt + row0 * 3 * kpad;
    for (int i = tid; i < nb * gpr; i += nt) {
      const int s = i / gpr, k0 = (i - s * gpr) * kVec % kpad;
      bool any = false;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        any |= (unsigned)sidx[s * kpad + k0 + v] < (unsigned)W;
      if (any) {
        cp_async16(sgt + (size_t)kVec * i, ggt + (size_t)kVec * i);
        live[s] = 1;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int s = 0; s < nb; ++s) {
      if (!live[s]) continue;  // the same for every thread of the block
      for (int i = tid; i < 3 * kpad; i += nt) {
        const int c = i / kpad, k = i - c * kpad;
        const int w = sidx[s * kpad + k];
        if ((unsigned)w < (unsigned)W)
          acc[3 * w + c] += sgt[((size_t)s * 3 + c) * kpad + k];
      }
      __syncthreads();
    }
  }
  // every add is behind a barrier here: the last live slot's, or phase 2's
  T* out = wing + (size_t)bin * 3 * W;
  for (int i = tid; i < 3 * W; i += nt) out[i] = -acc[i];
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
  const size_t smem = inv_smem<T>(g.cap, wpad);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(asn_build_inv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_build_inv_kernel<T><<<g.nx * g.ny * g.nz, 32 * kInvWarps, smem,
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

// Dynamic shared memory of a step kernel: each warp's buffer.
template <typename T>
size_t step_smem(const StepParams<T>& p, bool radial, bool stage2) {
  return sizeof(T) * kWarpsPerBlock *
         (size_t)step_buf_len(p.kpad, p.atot, radial, stage2);
}

// ip: nx ny nz cap wpad kpad NR atot srl has_rep env kf15 | sections |
//     a_s[8] a_off[8] col0[8] | n_part (the kernels with dh only)
// fp: rc eta mu0 delta tiny_e pmin rca big rep_rc kf alpha[8] zeff[8]
template <typename T>
bool step_params_from(const int* ip, const double* fp, StepParams<T>& p) {
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
      p.NR < 1 || p.NR > kMaxNR || p.atot < 0 || p.atot > kDeadSlot ||
      p.srl % p.NR || p.srl > kMaxS * kMaxNR)
    return false;
  const int* st = ip + 12 + kSecInts;
  for (int i = 0; i < kMaxS; ++i) {
    p.a_s[i] = st[i];
    p.a_off[i] = st[kMaxS + i];
    p.col0[i] = st[2 * kMaxS + i];
    p.alpha[i] = (T)fp[10 + i];
    p.zeff[i] = (T)fp[10 + kMaxS + i];
    // a section's NR columns are one whole block of the row's srl
    if (i < p.sec.n && (p.col0[i] < 0 || p.col0[i] % p.NR ||
                        p.col0[i] + p.NR > p.srl))
      return false;
  }
  const double rc = fp[0], rca = fp[6];
  p.rc = (T)rc;
  p.eta = (T)fp[1];
  p.mu0 = (T)fp[2];
  p.delta = (T)fp[3];
  p.tiny_e = (T)fp[4];
  p.pmin = (T)fp[5];
  p.geta = std::is_same<T, float>::value
               ? (T)(-fp[1] * 1.4426950408889634)  // -eta log2(e)
               : (T)(-fp[1]);
  p.pi_rc = (T)(kPi / rc);
  p.dfc_rk = (T)(-0.5 * kPi / rc);
  p.rca = (T)rca;
  p.pi_rca = (T)(kPi / rca);
  p.dfc_k = (T)(-0.5 * kPi / rca);
  p.big = (T)fp[7];
  p.rep_rc = (T)fp[8];
  p.kf = (T)fp[9];
  p.a2b = (T)1.8897261258369282;
  p.one_m = (T)(1.0 - 1e-6);
  p.pi = (T)kPi;
  return true;
}

template <typename T>
int asn_step_fused(const int* ip, const double* fp, const void* pos,
                   const void* sp, const void* h, const void* idx, void* rad,
                   void* cmp, void* rank2, void* deficit, void* stream) {
  StepParams<T> p;
  if (!step_params_from(ip, fp, p) || p.srl != p.sec.n * p.NR)
    return cudaErrorInvalidValue;
  const int nrows = p.g.nx * p.g.ny * p.g.nz * p.g.cap;
  const size_t smem = step_smem(p, true, true);
  cudaError_t err = set_smem(asn_step_fused_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_step_fused_kernel<T><<<row_blocks(nrows), kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const int16_t*)idx,
      (T*)rad, (T*)cmp, (int16_t*)rank2, (int*)deficit, p);
  return (int)cudaGetLastError();
}

// ip, fp: as asn_step_fused (the stage-2 entries are not read)
template <typename T>
int asn_radial_fwd_asn(const int* ip, const double* fp, const void* pos,
                       const void* sp, const void* h, const void* idx,
                       void* rad, void* stream) {
  StepParams<T> p;
  if (!step_params_from(ip, fp, p)) return cudaErrorInvalidValue;
  const int nrows = p.g.nx * p.g.ny * p.g.nz * p.g.cap;
  const size_t smem = step_smem(p, true, false);
  cudaError_t err = set_smem(asn_radial_fwd_asn_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_radial_fwd_asn_kernel<T><<<row_blocks(nrows), kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const int16_t*)idx,
      (T*)rad, p);
  return (int)cudaGetLastError();
}

// ip, fp: as asn_step_fused (the radial and repulsion entries are not read)
template <typename T>
int asn_compact_asn(const int* ip, const double* fp, const void* pos,
                    const void* sp, const void* h, const void* idx, void* cmp,
                    void* rank2, void* deficit, void* stream) {
  StepParams<T> p;
  if (!step_params_from(ip, fp, p)) return cudaErrorInvalidValue;
  const int nrows = p.g.nx * p.g.ny * p.g.nz * p.g.cap;
  const size_t smem = step_smem(p, false, true);
  cudaError_t err = set_smem(asn_compact_asn_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_compact_asn_kernel<T><<<row_blocks(nrows), kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const int16_t*)idx,
      (T*)cmp, (int16_t*)rank2, (int*)deficit, p);
  return (int)cudaGetLastError();
}

constexpr int kStepInts = 12 + kSecInts + 3 * kMaxS;

// The radial backward's dynamic shared memory: gamma_warp_bytes per warp.
template <typename T>
size_t gamma_smem(const StepParams<T>& p) {
  return kWarpsPerBlock * gamma_warp_bytes(p.kpad, p.srl, sizeof(T));
}

// ip: as asn_step_fused, then n_part (one dh partial per block); fp: as
// asn_step_fused
template <typename T>
int asn_radial_bwd_asn(const int* ip, const double* fp, const void* pos,
                       const void* sp, const void* h, const void* idx,
                       const void* ga, void* gr, void* fcen, void* dh_part,
                       void* dh, void* stream) {
  StepParams<T> p;
  if (!step_params_from(ip, fp, p)) return cudaErrorInvalidValue;
  const int nrows = p.g.nx * p.g.ny * p.g.nz * p.g.cap;
  const int n_part = ip[kStepInts];
  if (n_part != row_blocks(nrows)) return cudaErrorInvalidValue;
  const size_t smem = gamma_smem(p);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(asn_radial_bwd_asn_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  asn_radial_bwd_asn_kernel<T><<<n_part, kThreads, smem, st>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const int16_t*)idx,
      (const T*)ga, (T*)gr, (T*)fcen, (T*)dh_part, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dh_reduce_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)dh_part, n_part,
                                                 (T*)dh);
  return (int)cudaGetLastError();
}

// ip, fp: as asn_step_fused (the stage-2 entries are not read)
template <typename T>
int asn_radial_gamma(const int* ip, const double* fp, const void* pos,
                     const void* sp, const void* h, const void* idx,
                     const void* ga, void* gr, void* stream) {
  StepParams<T> p;
  if (!step_params_from(ip, fp, p)) return cudaErrorInvalidValue;
  const int nrows = p.g.nx * p.g.ny * p.g.nz * p.g.cap;
  const size_t smem = gamma_smem(p);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(asn_radial_gamma_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_radial_gamma_kernel<T><<<row_blocks(nrows), kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const int16_t*)idx,
      (const T*)ga, (T*)gr, p);
  return (int)cudaGetLastError();
}

// ip: rows atot n_blocks zeta_int | off1[28] off2[28] a1[28] a2[28]
//     same[28] | zeta_floor
// fp: rca eta zeta mu0 delta tiny cos_m[8] sin_m[8] pmin zeta_frac big
template <typename T>
bool packed_params_from(const int* ip, const double* fp, PackedParams<T>& p) {
  p.rows = ip[0];
  p.atot = ip[1];
  p.n_blocks = ip[2];
  p.zeta_int = ip[3];
  if (p.rows < 0 || p.atot < 1 || p.atot > kDeadSlot || p.n_blocks < 1 ||
      p.n_blocks > kMaxBlocks)
    return false;
  p.max_q = 0;
  for (int b = 0; b < kMaxBlocks; ++b) {
    p.off1[b] = ip[4 + b];
    p.off2[b] = ip[4 + kMaxBlocks + b];
    p.a1[b] = ip[4 + 2 * kMaxBlocks + b];
    p.a2[b] = ip[4 + 3 * kMaxBlocks + b];
    p.same[b] = ip[4 + 4 * kMaxBlocks + b];
    if (b >= p.n_blocks) continue;
    const int q = p.same[b] ? p.a1[b] * (p.a1[b] - 1) / 2 : p.a1[b] * p.a2[b];
    if (p.a1[b] < 1 || p.a2[b] < 1 || p.off1[b] < 0 ||
        p.off1[b] + p.a1[b] > p.atot || p.off2[b] < 0 ||
        p.off2[b] + p.a2[b] > p.atot || (p.same[b] && p.off2[b] != p.off1[b]))
      return false;
    if (q > p.max_q) p.max_q = q;
  }
  p.zeta_floor = ip[4 + 5 * kMaxBlocks];
  if (p.zeta_floor < 0) return false;
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
  p.zeta_frac = (T)fp[7 + 2 * kNZ];
  p.big = (T)fp[8 + 2 * kNZ];
  return true;
}

// `table`: the host lane table of the contract; the kernels enumerate the
// live pairs themselves and do not read it.
template <typename T>
int asn_packed_fwd(const int* ip, const double* fp, const void* cat,
                   const void* table, void* out, void* stream) {
  PackedParams<T> p;
  if (!packed_params_from(ip, fp, p)) return cudaErrorInvalidValue;
  if (p.rows == 0) return cudaSuccess;
  const size_t smem = sizeof(T) * kWarpsPerBlock * 5 * p.atot;
  cudaError_t err = set_smem(asn_packed_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_packed_fwd_kernel<T><<<row_blocks(p.rows), kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const T*)cat, (T*)out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int asn_packed_bwd(const int* ip, const double* fp, const void* cat,
                   const void* table, const void* ga, void* out,
                   void* stream) {
  PackedParams<T> p;
  if (!packed_params_from(ip, fp, p)) return cudaErrorInvalidValue;
  if (p.rows == 0) return cudaSuccess;
  // as many warps (rows) per block as the shared memory holds
  const size_t per_warp =
      sizeof(T) * (10 * (size_t)p.atot + 3 * p.max_q + kNAZ);
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kMaxSmem) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(asn_packed_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_packed_bwd_kernel<T><<<(p.rows + warps - 1) / warps, 32 * warps, smem,
                             (cudaStream_t)stream>>>(
      (const T*)cat, (const T*)ga, (T*)out, p, warps);
  return (int)cudaGetLastError();
}

// ip: rows atot off1 a1 off2 a2 same zeta_int
// fp: rca eta zeta mu0 delta tiny cos_m[8] sin_m[8]
// `tri`: the triangle form (one species, at least two slots).
template <typename T>
bool block_params_from(const int* ip, const double* fp, bool tri,
                       BlockParams<T>& p) {
  p.rows = ip[0];
  p.atot = ip[1];
  p.off1 = ip[2];
  p.a1 = ip[3];
  p.off2 = ip[4];
  p.a2 = ip[5];
  p.same = ip[6];
  p.zeta_int = ip[7];
  if (p.rows < 0 || p.atot < 1 || p.atot > kDeadSlot || p.a1 < 1 ||
      p.a2 < 1 || p.off1 < 0 || p.off1 + p.a1 > p.atot || p.off2 < 0 ||
      p.off2 + p.a2 > p.atot)
    return false;
  if ((p.same || tri) && (p.off1 != p.off2 || p.a1 != p.a2 || !p.same))
    return false;
  if (tri && p.a1 < 2) return false;
  p.q = tri ? p.a1 * (p.a1 - 1) / 2
            : (p.same ? p.a1 * (p.a1 - 1) : p.a1 * p.a2);
  const double zf = floor(fp[2]);
  p.zeta_floor = (int)zf;
  if (p.zeta_floor < 0) return false;
  p.zeta_frac = (T)(fp[2] - zf);
  p.big = (T)(2.0 * fp[0] + 10.0);
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
  return true;
}

template <typename T>
int asn_block_fwd(const int* ip, const double* fp, bool tri,
                  const void* cat, void* out, void* stream) {
  BlockParams<T> p;
  if (!block_params_from(ip, fp, tri, p)) return cudaErrorInvalidValue;
  if (p.rows == 0) return cudaSuccess;
  const size_t smem =
      sizeof(T) * kFwdWarps * 5 * (p.same ? p.a1 : p.a1 + p.a2);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = tri ? asn_block_fwd_tri_kernel<T> : asn_block_fwd_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(p.rows + kFwdWarps - 1) / kFwdWarps, 32 * kFwdWarps, smem,
           (cudaStream_t)stream>>>((const T*)cat, (T*)out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int asn_block_bwd(const int* ip, const double* fp, bool tri,
                  const void* cat, const void* ga, void* acc, void* stream) {
  BlockParams<T> p;
  if (!block_params_from(ip, fp, tri, p)) return cudaErrorInvalidValue;
  if (p.rows == 0) return cudaSuccess;
  // the same-species forms walk the triangle (block_bwd_row)
  if (p.same) p.q = p.a1 * (p.a1 - 1) / 2;
  // as many warps (rows) per block as the shared memory holds
  const size_t per_warp =
      sizeof(T) * (5 * (size_t)(p.same ? p.a1 : p.a1 + p.a2) + 3 * p.q +
                   kNAZ);
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kMaxSmem) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = tri ? asn_block_bwd_tri_kernel<T> : asn_block_bwd_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(p.rows + warps - 1) / warps, 32 * warps, smem,
           (cudaStream_t)stream>>>((const T*)cat, (const T*)ga, (T*)acc, p,
                                   warps);
  return (int)cudaGetLastError();
}

// ip: nx ny nz cap kpad atot n_part; fp: the live-slot distance bound
template <typename T>
int asn_chain_sum(const int* ip, const double* fp, const void* rank2,
                  const void* idx, const void* cmp, const void* gsum,
                  const void* gr, void* gt, void* fcen, void* dh_part,
                  void* dh, void* stream) {
  const Grid g = grid_from(ip);
  const int kpad = ip[4], atot = ip[5], n_part = ip[6];
  const int nrows = g.nx * g.ny * g.nz * g.cap;
  if (g.cap < 1 || kpad < 32 || kpad % 32 || atot < 0 || atot > kDeadSlot ||
      n_part != row_blocks(nrows))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  asn_chain_sum_kernel<T><<<n_part, kThreads, 0, st>>>(
      (const int16_t*)rank2, (const int16_t*)idx, (const T*)cmp,
      (const T*)gsum, (const T*)gr, (T*)gt, (T*)fcen, (T*)dh_part, g, kpad,
      atot, (T)fp[0]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dh_reduce_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)dh_part, n_part,
                                                 (T*)dh);
  return (int)cudaGetLastError();
}

// ip, fp: as asn_chain_sum
template <typename T>
int asn_decompact_chain(const int* ip, const double* fp, const void* rank2,
                        const void* idx, const void* cmp, const void* gsum,
                        void* gt, void* fcen, void* dh_part, void* dh,
                        void* stream) {
  const Grid g = grid_from(ip);
  const int kpad = ip[4], atot = ip[5], n_part = ip[6];
  const int nrows = g.nx * g.ny * g.nz * g.cap;
  if (g.cap < 1 || kpad < 32 || kpad % 32 || atot < 0 || atot > kDeadSlot ||
      n_part != row_blocks(nrows))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  asn_decompact_chain_kernel<T><<<n_part, kThreads, 0, st>>>(
      (const int16_t*)rank2, (const int16_t*)idx, (const T*)cmp,
      (const T*)gsum, (T*)gt, (T*)fcen, (T*)dh_part, g, kpad, atot, (T)fp[0]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dh_reduce_kernel<T><<<1, kRedThreads, 0, st>>>((const T*)dh_part, n_part,
                                                 (T*)dh);
  return (int)cudaGetLastError();
}

// ip: nc cap wpad kpad
template <typename T>
int asn_wing(const int* ip, const double*, const void* gt, const void* idx,
             void* wing, void* stream) {
  const int nc = ip[0], cap = ip[1], wpad = ip[2], kpad = ip[3];
  if (nc < 1 || cap < 1 || wpad < 27 * cap || wpad >= 32768 || kpad < 32 ||
      kpad % 32)
    return cudaErrorInvalidValue;
  // kWingBatch slots at a time, fewer where they do not fit
  int batch = cap < kWingBatch ? cap : kWingBatch;
  while (batch > 1 && wing_smem<T>(cap, kpad, batch).total > kMaxSmem)
    --batch;
  const size_t smem = wing_smem<T>(cap, kpad, batch).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(asn_wing_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  asn_wing_kernel<T><<<nc, kWingThreads, smem, (cudaStream_t)stream>>>(
      (const T*)gt, (const int16_t*)idx, (T*)wing, cap, kpad, batch);
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
  }                                                                           \
  extern "C" int asn_radial_gamma_##SUF(                                     \
      const int* ip, const double* fp, const void* pos, const void* sp,      \
      const void* h, const void* idx, const void* ga, void* gr,              \
      void* stream) {                                                         \
    return asn_radial_gamma<T>(ip, fp, pos, sp, h, idx, ga, gr, stream);     \
  }                                                                           \
  extern "C" int asn_packed_bwd_##SUF(const int* ip, const double* fp,       \
                                      const void* cat, const void* table,    \
                                      const void* ga, void* out,             \
                                      void* stream) {                         \
    return asn_packed_bwd<T>(ip, fp, cat, table, ga, out, stream);           \
  }                                                                           \
  extern "C" int asn_chain_sum_##SUF(                                        \
      const int* ip, const double* fp, const void* rank2, const void* idx,   \
      const void* cmp, const void* gsum, const void* gr, void* gt,           \
      void* fcen, void* dh_part, void* dh, void* stream) {                   \
    return asn_chain_sum<T>(ip, fp, rank2, idx, cmp, gsum, gr, gt, fcen,     \
                            dh_part, dh, stream);                             \
  }                                                                           \
  extern "C" int asn_radial_fwd_asn_##SUF(                                   \
      const int* ip, const double* fp, const void* pos, const void* sp,      \
      const void* h, const void* idx, void* rad, void* stream) {             \
    return asn_radial_fwd_asn<T>(ip, fp, pos, sp, h, idx, rad, stream);      \
  }                                                                           \
  extern "C" int asn_compact_asn_##SUF(                                      \
      const int* ip, const double* fp, const void* pos, const void* sp,      \
      const void* h, const void* idx, void* cmp, void* rank2, void* deficit, \
      void* stream) {                                                         \
    return asn_compact_asn<T>(ip, fp, pos, sp, h, idx, cmp, rank2, deficit,  \
                              stream);                                        \
  }                                                                           \
  extern "C" int asn_radial_bwd_asn_##SUF(                                   \
      const int* ip, const double* fp, const void* pos, const void* sp,      \
      const void* h, const void* idx, const void* ga, void* gr, void* fcen,  \
      void* dh_part, void* dh, void* stream) {                               \
    return asn_radial_bwd_asn<T>(ip, fp, pos, sp, h, idx, ga, gr, fcen,      \
                                 dh_part, dh, stream);                        \
  }                                                                           \
  extern "C" int asn_decompact_chain_##SUF(                                  \
      const int* ip, const double* fp, const void* rank2, const void* idx,   \
      const void* cmp, const void* gsum, void* gt, void* fcen,               \
      void* dh_part, void* dh, void* stream) {                               \
    return asn_decompact_chain<T>(ip, fp, rank2, idx, cmp, gsum, gt, fcen,   \
                                  dh_part, dh, stream);                       \
  }                                                                           \
  extern "C" int asn_wing_##SUF(const int* ip, const double* fp,             \
                                const void* gt, const void* idx, void* wing, \
                                void* stream) {                               \
    return asn_wing<T>(ip, fp, gt, idx, wing, stream);                       \
  }                                                                           \
  extern "C" int asn_block_fwd_##SUF(const int* ip, const double* fp,        \
                                     const void* cat, void* out,             \
                                     void* stream) {                          \
    return asn_block_fwd<T>(ip, fp, false, cat, out, stream);                \
  }                                                                           \
  extern "C" int asn_block_fwd_tri_##SUF(const int* ip, const double* fp,    \
                                         const void* cat, void* out,         \
                                         void* stream) {                      \
    return asn_block_fwd<T>(ip, fp, true, cat, out, stream);                 \
  }                                                                           \
  extern "C" int asn_block_bwd_##SUF(const int* ip, const double* fp,        \
                                     const void* cat, const void* ga,        \
                                     void* acc, void* stream) {               \
    return asn_block_bwd<T>(ip, fp, false, cat, ga, acc, stream);            \
  }                                                                           \
  extern "C" int asn_block_bwd_tri_##SUF(const int* ip, const double* fp,    \
                                         const void* cat, const void* ga,    \
                                         void* acc, void* stream) {           \
    return asn_block_bwd<T>(ip, fp, true, cat, ga, acc, stream);             \
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
