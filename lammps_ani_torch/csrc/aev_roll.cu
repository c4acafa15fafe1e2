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
//     materialized, and the window is staged in shared memory once per
//     bin (radial_fwd: in passes of a fixed lane count; radial_bwd: an
//     x-plane of the window at a time where it fits, else a row; the
//     angular kernels: the whole 27-bin window where it fits, as at every
//     cap the engines size, else in passes of whole offsets).
//   * The TPU grid runs in order, so its kernels carry sums across grid
//     steps (fcen over candidate groups, dh over the whole grid, the
//     deficit as a running max). Blocks here run in any order: fcen and
//     wing are complete within a block, every sum in a fixed order (no
//     floating-point atomics: two calls agree bit for bit), dh is written
//     as per-block partials and summed in a fixed order by a second
//     one-block kernel, and the deficit is an integer atomicMax.
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

// ---------------------------------------------------------------------------
// Radial forward — replaces aev_pallas.py:260 _radial_fwd_kernel.
//
// out[cell, a, s*NR + k] = sum over window lanes of species s within Rcr
//   0.25 fc(d) exp(-eta (d - mu0 - k delta)^2)
// (self excluded); columns of absent species and rows of empty slots are 0.
// Bound (chip_smoke.py OPS): fp32 instructions per real candidate of a
// real center's window (the squared distance test) and fp32 instructions
// and special-function results per in-cutoff pair (the square root, 16
// Gaussians and the cutoff's cosine), against the bytes of the real rows'
// output; the contract's padded [NC, cap, S NR] output (the layout floor)
// is three times those bytes at the roll grid's occupancy.
// Design: one block per bin. The block first writes zeros to every entry of
// its bin's rows (the wrapper does not zero the output), then stages the
// window's lanes of present species in shared memory, compacted in lane
// order (a block scan of ballots; positions by candidate_pos, so every
// distance has the bits it has from the grid), p.chunk window lanes a pass
// (the host's choice, radial_fwd below). The bin's real centers go one a
// warp (empty slots get no warp): the warp tests the staged lanes 32 at a
// time (a squared distance a lane, the square root only where it may lie
// within Rcr) and packs the in-cutoff ones by ballot onto full warps (at
// most 63 waiting), where each lane takes one pair, every species in the
// same pass: the hardware cosine (the argument lies in [0, pi]) and, in
// f32, the 16 Gaussians by ex2 (gauss_of). A group's sums go to each
// present species by a register reduce-scatter of its 16 columns (16
// shuffles, skipped for a species with no pair in the group), lane k adding
// column k to the center's row of the output, which no other warp touches
// (as registers, one a present species, the sums spilled; in shared memory
// they took 1.7 KB a slot in f64, more than a block has at large caps):
// every sum in a fixed order, so two calls agree bit for bit.
// ---------------------------------------------------------------------------
constexpr int kRfMaxWarps = 8;
constexpr int kRfPack = 64;  // a warp's in-cutoff lanes waiting (< 2 groups)

__host__ __device__ inline unsigned al16(size_t b) {
  return (unsigned)((b + 15) & ~(size_t)15);
}

template <typename T>
struct RfParams {
  int shell, S, NR, chunk;  // chunk: window lanes staged a pass
  unsigned present;         // bit s: species s is present
  // rc2_hi: the least float above rc^2 (1 + 2^-20): a lane with d2 above it
  // has sqrt(max(d2, 1e-12)) > rc, so only the others take the square root
  T rc, rc2_hi, mu0, delta, pi_rc, geta;
};

// Dynamic shared memory of radial_fwd, byte offsets: the staged lanes
// WinLane [chunk] (species | window lane << 4), the real centers int [cap];
// then each warp's packed lanes, species int [kRfPack] and distances T
// [kRfPack].
struct RfLayout {
  unsigned ctr, warps, pd, warp_bytes;
};

template <typename T>
__host__ __device__ RfLayout rf_layout(int cap, int chunk) {
  RfLayout L;
  L.ctr = al16(sizeof(WinLane<T>) * (size_t)chunk);
  L.warps = L.ctr + al16(sizeof(int) * (size_t)cap);
  L.pd = al16(sizeof(int) * kRfPack);
  L.warp_bytes = L.pd + al16(sizeof(T) * kRfPack);
  return L;
}

// One group of n <= 32 packed pairs (species es, distance dd on lanes < n)
// added to the sums of center row me of the output, one species after the
// other: lane k < NR adds column k. (The row goes by its index: a 64-bit
// pointer held across the passes spilled beside the square root's call.)
template <typename T>
__device__ __forceinline__ void rf_group(const RfParams<T>& p, int es, T dd,
                                         int lane, T* out, int me) {
  T g[kMaxNR];
  const T pref = T(0.125) * cos_0pi(dd * p.pi_rc) + T(0.125);  // 0.25 fc
  const T x = dd - p.mu0;
#pragma unroll
  for (int k = 0; k < kMaxNR; ++k) {
    const T xk = x - T(k) * p.delta;
    g[k] = (es >= 0 && k < p.NR) ? pref * gauss_of(p.geta * xk * xk) : T(0);
  }
  for (int s = 0; s < p.S; ++s) {
    if (!(p.present >> s & 1u) || !__any_sync(kFull, es == s)) continue;
    T v[kMaxNR];
#pragma unroll
    for (int k = 0; k < kMaxNR; ++k) v[k] = es == s ? g[k] : T(0);
    reduce_step<8>(v, lane);
    reduce_step<4>(v, lane);
    reduce_step<2>(v, lane);
    reduce_step<1>(v, lane);
    const T sum = v[0] + __shfl_xor_sync(kFull, v[0], 16);
    if (lane < p.NR) out[((size_t)me * p.S + s) * p.NR + lane] += sum;
  }
}

// Center (cx, cy, cz) of window lane self_lane against the n_kept staged
// lanes, on one warp: its pairs within Rcr in ascending lane order, packed
// by ballot onto full warps, added to its output row me group after group.
template <typename T>
__device__ __forceinline__ void rf_center(const RfParams<T>& p,
                                          const WinLane<T>* kept, int n_kept,
                                          int self_lane, T cx, T cy, T cz,
                                          int* ent, T* pd, int lane,
                                          T* out, int me) {
  const unsigned below = (1u << lane) - 1u;
  int npk = 0;
  for (int base = 0; base < n_kept; base += 32) {
    const int i = base + lane;
    bool m = false;
    T d = T(0);
    int e = 0;
    if (i < n_kept) {
      const WinLane<T> c = kept[i];
      const T dx = cx - c.x, dy = cy - c.y, dz = cz - c.z;
      const T d2 = dx * dx + dy * dy + dz * dz;
      if ((c.sp >> 4) != self_lane && d2 <= p.rc2_hi) {
        d = m_sqrt(d2 > T(1e-12) ? d2 : T(1e-12));
        m = d <= p.rc;
        e = c.sp & 15;
      }
    }
    const unsigned bal = __ballot_sync(kFull, m);
    if (m) {
      const int j = npk + __popc(bal & below);
      ent[j] = e;
      pd[j] = d;
    }
    npk += __popc(bal);
    // full groups of 32, and at the last chunk what is left
    const bool last = base + 32 >= n_kept;
    while (npk >= 32 || (last && npk > 0)) {
      const int n = npk < 32 ? npk : 32;
      __syncwarp();
      const int es = lane < n ? ent[lane] : -1;
      const T dd = lane < n ? pd[lane] : p.rc;
      rf_group(p, es, dd, lane, out, me);
      npk -= n;
      // the waiting rest (fewer than 32) moves down to the front
      int e2 = 0;
      T d2 = T(0);
      if (lane < npk) {
        e2 = ent[32 + lane];
        d2 = pd[32 + lane];
      }
      __syncwarp();
      if (lane < npk) {
        ent[lane] = e2;
        pd[lane] = d2;
      }
    }
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(32 * kRfMaxWarps) radial_fwd_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, T* __restrict__ out, Grid g, RfParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[125];
  __shared__ int wtot[kRfMaxWarps];
  __shared__ int n_ctr_s;
  const int cell = blockIdx.x, cap = g.cap;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int ns = 2 * p.shell + 1, n_off = ns * ns * ns;
  const int SR = p.S * p.NR, self_off = (n_off - 1) / 2;
  const RfLayout L = rf_layout<T>(cap, p.chunk);
  WinLane<T>* kept = reinterpret_cast<WinLane<T>*>(smem_raw);
  int* ctr = reinterpret_cast<int*>(smem_raw + L.ctr);
  unsigned char* scratch = smem_raw + L.warps + warp * L.warp_bytes;
  int* ent = reinterpret_cast<int*>(scratch);
  T* pd = reinterpret_cast<T*>(scratch + L.pd);
  const unsigned below = (1u << lane) - 1u;
  // every entry of the bin's rows starts at 0, in 16-byte stores where they
  // allow it
  T* ocell = out + (size_t)cell * cap * SR;
  constexpr int V = 16 / sizeof(T);
  if ((reinterpret_cast<size_t>(ocell) & 15) == 0 && SR % V == 0) {
    int4* o4 = reinterpret_cast<int4*>(ocell);
    for (int i = threadIdx.x; i < cap * SR / V; i += blockDim.x)
      o4[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int i = threadIdx.x; i < cap * SR; i += blockDim.x) ocell[i] = T(0);
  }
  // each offset's first grid slot and packed wrap shift, once
  for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
    int ox, oy, oz, sx, sy, sz;
    offset_of(o, p.shell, ox, oy, oz);
    const int base = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * cap;
    tab[o] = make_int2(base, (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4);
  }
  // the bin's real centers, in slot order
  if (warp == 0) {
    int n = 0;
    for (int b0 = 0; b0 < cap; b0 += 32) {
      const bool r = b0 + lane < cap && sp[cell * cap + b0 + lane] >= 0;
      const unsigned bal = __ballot_sync(kFull, r);
      if (r) ctr[n + __popc(bal & below)] = b0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_ctr_s = n;
  }
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  __syncthreads();  // the zeros are the centers' rows
  const int n_ctr = n_ctr_s;
  if (n_ctr == 0) return;
  const int W = n_off * cap;
  for (int w0 = 0; w0 < W; w0 += p.chunk) {
    const int WL = min(p.chunk, W - w0);
    // the lanes of present species, compacted in lane order
    int n_kept = 0;
    for (int base = 0; base < WL; base += blockDim.x) {
      const int lw = w0 + base + threadIdx.x;
      WinLane<T> c;
      bool k = false;
      if (base + threadIdx.x < WL) {
        const int oo = lw / cap;
        const int2 t = tab[oo];
        const int q = t.x + (lw - oo * cap);
        const int s = sp[q];
        if (s >= 0 && (p.present >> s & 1u)) {
          candidate_pos(pos, q, h, (t.y & 3) - 1, (t.y >> 2 & 3) - 1,
                        (t.y >> 4 & 3) - 1, c.x, c.y, c.z);
          c.sp = s | lw << 4;
          k = true;
        }
      }
      const unsigned bal = __ballot_sync(kFull, k);
      if (lane == 0) wtot[warp] = __popc(bal);
      __syncthreads();
      int at = n_kept + __popc(bal & below), total = 0;
      for (int v = 0; v < nw; ++v) {
        if (v < warp) at += wtot[v];
        total += wtot[v];
      }
      if (k) kept[at] = c;
      n_kept += total;
      __syncthreads();
    }
    for (int ci = warp; ci < n_ctr; ci += nw) {
      const int a = ctr[ci];
      const int me = cell * cap + a;
      rf_center(p, kept, n_kept, self_off * cap + a, pos[me * 3],
                pos[me * 3 + 1], pos[me * 3 + 2], ent, pd, lane, out, me);
    }
    __syncthreads();  // the staged lanes are the next pass's
  }
}

// ---------------------------------------------------------------------------
// Radial backward — replaces aev_pallas.py:299 _radial_bwd_kernel.
//
// For the cotangent ga [NC, cap, S*NR]: per pair (center a, window lane w
// of a present species within Rcr, self excluded)
//   gamma = sum_k ga[a, s_w*NR + k] 0.25 e_k (dfc - 2 eta x_k fc)
// and g = gamma (center - candidate) / d; fcen[cell, a] = sum_w g (center
// role), wing[cell, w] = -sum_a g (neighbor role, folded back to the owner
// bins by torch rolls), dh partial = sum_w S_w^T wing_w.
// Bound (chip_smoke.py OPS): fp32 instructions per real candidate of a
// real center's window (the squared distance test) and fp32 instructions
// and special-function results per in-cutoff pair (the square root, 16
// Gaussians, the cutoff's cosine and sine, the chain), against the bytes
// of ga in and dpos out; the contract's wing slab [NC, n_off cap, 3] (the
// layout floor) is ten times those bytes.
// Design: one block per bin, in passes of whole window offsets (the
// host's choice: an x-plane, (2 shell + 1)^2 offsets, where a block of
// kRbMaxWarps warps holds its layout, else an x-y row of 2 shell + 1
// offsets, else one, so every cap up to 256 fits in both dtypes; a whole
// window's lanes and wing need 112 KB in f32 at cap 32 and do not fit
// beside the scratch in f64, a plane 22 KB). Per pass the block stages the pass's lanes of present
// species, compacted in lane order (a block scan of ballots), and zeroes
// the pass's wing in shared memory. The bin's real centers go in rounds, one
// a warp, in slot order: the warp tests the compacted lanes 32 at a time
// (a squared distance a lane, the square root only where it may lie within
// Rcr) and packs the in-cutoff ones by ballot onto full warps (at most 63
// waiting), where each lane takes one pair: f32 ex2
// Gaussians (gauss_of) and the hardware cosine and sine (the argument lies
// in [0, pi]), gamma / d by quot<true>. Each pair is evaluated once: its g
// goes to the center's fcen sums (registers, a warp sum, added to the
// center's shared fcen pass after pass) and, with its lane, to the warp's
// store. Then each warp owns a range of the pass's lanes and adds the
// stores in warp order, which is center order: every wing entry is a sum
// in center order, at any warp count, and two calls agree bit for bit. A
// round in which a center found more pairs than its warp's store holds is
// run again center after center, each warp adding its pairs straight to
// the wing: the same values in the same order. The pass's wing leaves in
// 16-byte stores, and its per-offset sums stay for dh (an interior bin,
// every shift 0, writes 0 without them); dh_reduce_kernel sums the bins'
// partials.
// ---------------------------------------------------------------------------
constexpr int kRbMaxWarps = 8;
constexpr int kRbPack = 64;    // a warp's in-cutoff lanes waiting (< 2 groups)
constexpr int kRbStore = 128;  // a warp's stored pairs (the center's pass)

template <typename T>
struct RbParams {
  int shell, S, NR, K;
  int opp;  // window offsets staged a pass
  unsigned present;
  // rc2_hi: the least float above rc^2 (1 + 2^-20): a lane with d2 above it
  // has sqrt(max(d2, 1e-12)) > rc, so only the others take the square root
  T rc, rc2_hi, mu0, delta, pi_rc, dfc_rk, geta, two_eta;
};

// Dynamic shared memory of radial_bwd, byte offsets: a pass's kept lanes
// WinLane [opp cap] (species | window lane << 4), its wing T [3 opp cap],
// the centers' fcen sums T [3 cap], the per-offset wing sums T [3 n_off],
// the real centers int [cap]; then each warp's scratch: the center's
// cotangent row T [S NR], the packed lanes' entries int [kRbPack] (pass
// lane << 4 | species) and values T [4][kRbPack] (dx, dy, dz, d), and the
// stored pairs WinLane [K] (g, pass lane).
struct RbLayout {
  unsigned wing, fcen, osum, ctr, warps, ent, pk, store, warp_bytes;
};

template <typename T>
__host__ __device__ RbLayout rb_layout(int cap, int shell, int SR, int K,
                                       int opp) {
  const int ns = 2 * shell + 1, n_off = ns * ns * ns;
  RbLayout L;
  L.wing = al16(sizeof(WinLane<T>) * (size_t)opp * cap);
  L.fcen = L.wing + al16(sizeof(T) * 3 * (size_t)opp * cap);
  L.osum = L.fcen + al16(sizeof(T) * 3 * (size_t)cap);
  L.ctr = L.osum + al16(sizeof(T) * 3 * (size_t)n_off);
  L.warps = L.ctr + al16(sizeof(int) * (size_t)cap);
  L.ent = al16(sizeof(T) * (size_t)SR);
  L.pk = L.ent + al16(sizeof(int) * kRbPack);
  L.store = L.pk + al16(sizeof(T) * 4 * kRbPack);
  L.warp_bytes = L.store + (unsigned)(sizeof(WinLane<T>) * (size_t)K);
  return L;
}

template <typename T>
__device__ __forceinline__ WinLane<T>* rb_store(unsigned char* raw,
                                                const RbLayout& L, int warp) {
  return reinterpret_cast<WinLane<T>*>(raw + L.warps + warp * L.warp_bytes +
                                       L.store);
}

// Center `me` of the bin (its window lane self_lane) against the pass's
// n_kept compacted lanes (pass lanes from w0), on one warp: its pairs
// within Rcr in ascending lane order, packed by ballot onto full warps,
// one pair a lane: g = gamma (center - candidate) / d, added to the lane's
// fcen sums and either stored in the warp's store (while fewer than K) or,
// `direct`, subtracted from the pass's wing at its lane (a center's pairs
// name distinct lanes). Returns the pair count.
template <typename T>
__device__ __forceinline__ int rb_center(
    const RbParams<T>& p, const T* __restrict__ pos,
    const T* __restrict__ ga, const WinLane<T>* kept, int n_kept, int w0,
    unsigned char* scratch, const RbLayout& L, T* wing_s, int me,
    int self_lane, bool direct, int lane, T& fx, T& fy, T& fz) {
  T* gas = reinterpret_cast<T*>(scratch);
  int* ent = reinterpret_cast<int*>(scratch + L.ent);
  T* pk = reinterpret_cast<T*>(scratch + L.pk);  // [4][kRbPack]
  WinLane<T>* store = reinterpret_cast<WinLane<T>*>(scratch + L.store);
  const int SR = p.S * p.NR;
  for (int i = lane; i < SR; i += 32) gas[i] = ga[(size_t)me * SR + i];
  const T cx = pos[me * 3], cy = pos[me * 3 + 1], cz = pos[me * 3 + 2];
  const unsigned below = (1u << lane) - 1u;
  fx = fy = fz = T(0);
  int npk = 0, n_all = 0;
  __syncwarp();
  for (int base = 0; base < n_kept; base += 32) {
    const int i = base + lane;
    bool m = false;
    T dx = T(0), dy = T(0), dz = T(0), d = T(0);
    int e = 0;
    if (i < n_kept) {
      const WinLane<T> c = kept[i];
      const int wl = c.sp >> 4;
      dx = cx - c.x;
      dy = cy - c.y;
      dz = cz - c.z;
      const T d2 = dx * dx + dy * dy + dz * dz;
      if (wl != self_lane && d2 <= p.rc2_hi) {
        d = m_sqrt(d2 > T(1e-12) ? d2 : T(1e-12));
        m = d <= p.rc;
        e = (wl - w0) << 4 | (c.sp & 15);
      }
    }
    const unsigned bal = __ballot_sync(kFull, m);
    if (m) {
      const int j = npk + __popc(bal & below);
      ent[j] = e;
      pk[j] = dx;
      pk[kRbPack + j] = dy;
      pk[2 * kRbPack + j] = dz;
      pk[3 * kRbPack + j] = d;
    }
    npk += __popc(bal);
    // full groups of 32, and at the last chunk what is left
    const bool last = base + 32 >= n_kept;
    while (npk >= 32 || (last && npk > 0)) {
      const int n = npk < 32 ? npk : 32;
      __syncwarp();
      if (lane < n) {
        const int en = ent[lane];
        const int lw = en >> 4;
        const T dd = pk[3 * kRbPack + lane];
        const T arg = dd * p.pi_rc;
        const T fc = T(0.5) * cos_0pi(arg) + T(0.5);
        const T dfc = p.dfc_rk * sin_0pi(arg);
        const T x = dd - p.mu0;
        const T* gsec = gas + (en & 15) * p.NR;
        T gamma = T(0);
#pragma unroll
        for (int k = 0; k < kMaxNR; ++k) {
          if (k < p.NR) {
            const T xk = x - T(k) * p.delta;
            const T g = gauss_of(p.geta * xk * xk);
            gamma += gsec[k] * (T(0.25) * g * (dfc - p.two_eta * xk * fc));
          }
        }
        const T gd = quot<true>(gamma, dd);
        const T gx = gd * pk[lane], gy = gd * pk[kRbPack + lane];
        const T gz = gd * pk[2 * kRbPack + lane];
        fx += gx;
        fy += gy;
        fz += gz;
        if (direct) {
          wing_s[3 * lw] -= gx;
          wing_s[3 * lw + 1] -= gy;
          wing_s[3 * lw + 2] -= gz;
        } else if (n_all + lane < p.K) {
          WinLane<T> r;
          r.x = gx;
          r.y = gy;
          r.z = gz;
          r.sp = lw;
          store[n_all + lane] = r;
        }
      }
      n_all += n;
      npk -= n;
      // the waiting rest (fewer than 32) moves down to the front
      __syncwarp();
      int e2 = 0;
      T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0);
      if (lane < npk) {
        e2 = ent[32 + lane];
        v0 = pk[32 + lane];
        v1 = pk[kRbPack + 32 + lane];
        v2 = pk[2 * kRbPack + 32 + lane];
        v3 = pk[3 * kRbPack + 32 + lane];
      }
      __syncwarp();
      if (lane < npk) {
        ent[lane] = e2;
        pk[lane] = v0;
        pk[kRbPack + lane] = v1;
        pk[2 * kRbPack + lane] = v2;
        pk[3 * kRbPack + lane] = v3;
      }
    }
  }
  __syncwarp();
  return n_all;
}

// n values from shared src to device dst, in 16-byte stores where both
// allow it (the same on every thread of the block).
template <typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ dst, const T* src,
                                         int n) {
  constexpr int V = 16 / sizeof(T);
  if ((reinterpret_cast<size_t>(dst) & 15) == 0 && n % V == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / V; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// PLANE: a pass is an x-plane of the window (P = ns^2 offsets; the host
// takes it where the layout holds it); else p.opp offsets. (One body with
// the pass width read from p spilled the pass bookkeeping at 64
// registers; the plane, as a compile-time form, keeps none.)
template <typename T, bool PLANE>
__global__ void __launch_bounds__(32 * kRbMaxWarps) radial_bwd_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const T* __restrict__ ga,
    T* __restrict__ fcen, T* __restrict__ wing, T* __restrict__ dh_part,
    Grid g, RbParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[125];
  __shared__ int wtot[kRbMaxWarps], cnt[kRbMaxWarps];
  __shared__ int n_ctr_s;
  const int cell = blockIdx.x, cap = g.cap;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int ns = 2 * p.shell + 1, P = PLANE ? ns * ns : p.opp;
  const int n_off = ns * ns * ns, n_pass = PLANE ? ns : n_off / P;
  const int PL = P * cap, self_lane = (n_off - 1) / 2 * cap;
  const RbLayout L = rb_layout<T>(cap, p.shell, p.S * p.NR, p.K, P);
  WinLane<T>* kept = reinterpret_cast<WinLane<T>*>(smem_raw);
  T* wing_s = reinterpret_cast<T*>(smem_raw + L.wing);
  T* fcen_s = reinterpret_cast<T*>(smem_raw + L.fcen);
  T* osum = reinterpret_cast<T*>(smem_raw + L.osum);
  int* ctr = reinterpret_cast<int*>(smem_raw + L.ctr);
  unsigned char* scratch = smem_raw + L.warps + warp * L.warp_bytes;
  const unsigned below = (1u << lane) - 1u;
  // each offset's first grid slot and packed wrap shift, once
  for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
    int ox, oy, oz, sx, sy, sz;
    offset_of(o, p.shell, ox, oy, oz);
    const int base = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * cap;
    tab[o] = make_int2(base, (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4);
  }
  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x) fcen_s[i] = T(0);
  // the bin's real centers, in slot order
  if (warp == 0) {
    int n = 0;
    for (int b0 = 0; b0 < cap; b0 += 32) {
      const bool r = b0 + lane < cap && sp[cell * cap + b0 + lane] >= 0;
      const unsigned bal = __ballot_sync(kFull, r);
      if (r) ctr[n + __popc(bal & below)] = b0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_ctr_s = n;
  }
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  const int iz = cell % g.nz, iy = (cell / g.nz) % g.ny;
  const int ix = cell / (g.ny * g.nz);
  const int sh = p.shell;
  const bool interior = ix >= sh && ix < g.nx - sh && iy >= sh &&
                        iy < g.ny - sh && iz >= sh && iz < g.nz - sh;
  __syncthreads();
  const int n_ctr = n_ctr_s;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int o0 = pass * P, w0 = o0 * cap;
    for (int i = threadIdx.x; i < 3 * PL; i += blockDim.x) wing_s[i] = T(0);
    // the pass's lanes of present species, compacted in lane order
    int n_kept = 0;
    for (int base = 0; base < PL; base += blockDim.x) {
      const int lw = base + threadIdx.x;
      WinLane<T> c;
      bool k = false;
      if (lw < PL) {
        const int oo = lw / cap;
        const int2 t = tab[o0 + oo];
        const int q = t.x + (lw - oo * cap);
        const int s = sp[q];
        if (s >= 0 && (p.present >> s & 1u)) {
          candidate_pos(pos, q, h, (t.y & 3) - 1, (t.y >> 2 & 3) - 1,
                        (t.y >> 4 & 3) - 1, c.x, c.y, c.z);
          c.sp = s | (w0 + lw) << 4;
          k = true;
        }
      }
      const unsigned bal = __ballot_sync(kFull, k);
      if (lane == 0) wtot[warp] = __popc(bal);
      __syncthreads();
      int at = n_kept + __popc(bal & below), total = 0;
      for (int v = 0; v < nw; ++v) {
        if (v < warp) at += wtot[v];
        total += wtot[v];
      }
      if (k) kept[at] = c;
      n_kept += total;
      __syncthreads();
    }
    // the real centers in rounds of nw, one a warp, in slot order. Step
    // -1: every warp its center, into its store; if a store overflowed,
    // steps 0, 1, ...: warp v alone, adding its pairs to the wing itself
    for (int r0 = 0; r0 < n_ctr; r0 += nw) {
      const int ci = r0 + warp;
      bool over = false;
      for (int step = -1; step < nw; ++step) {
        if (step >= 0 && !over) break;
        if (ci < n_ctr && (step < 0 || step == warp)) {
          const int a = ctr[ci];
          T fx, fy, fz;
          const int found = rb_center(p, pos, ga, kept, n_kept, w0, scratch,
                                      L, wing_s, cell * cap + a,
                                      self_lane + a, step >= 0, lane, fx,
                                      fy, fz);
          if (step < 0) {
            fx = warp_sum(fx);
            fy = warp_sum(fy);
            fz = warp_sum(fz);
            if (lane == 0) {
              fcen_s[3 * a] += fx;
              fcen_s[3 * a + 1] += fy;
              fcen_s[3 * a + 2] += fz;
              cnt[warp] = found;
            }
          }
        } else if (step < 0 && lane == 0) {
          cnt[warp] = 0;
        }
        __syncthreads();
        if (step < 0) {
          for (int v = 0; v < nw; ++v) over |= cnt[v] > p.K;
          if (!over) {
            // each warp owns a range of the pass's lanes and adds the
            // stores in warp order (center order)
            const int per = (PL + nw - 1) / nw, lo = warp * per;
            const int hi = min(PL, lo + per);
            for (int v = 0; v < nw; ++v) {
              const WinLane<T>* st = rb_store<T>(smem_raw, L, v);
              for (int q = lane; q < cnt[v]; q += 32) {
                const WinLane<T> e = st[q];
                if (e.sp >= lo && e.sp < hi) {
                  wing_s[3 * e.sp] -= e.x;
                  wing_s[3 * e.sp + 1] -= e.y;
                  wing_s[3 * e.sp + 2] -= e.z;
                }
              }
              __syncwarp();
            }
            __syncthreads();
          }
        }
      }
    }
    copy_out(wing + ((size_t)cell * n_off * cap + w0) * 3, wing_s, 3 * PL);
    if (!interior) {
      for (int oo = warp; oo < P; oo += nw) {
        T v[3] = {T(0), T(0), T(0)};
        for (int b = lane; b < cap; b += 32)
#pragma unroll
          for (int c = 0; c < 3; ++c) v[c] += wing_s[3 * (oo * cap + b) + c];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] = warp_sum(v[c]);
          if (lane == 0) osum[3 * (o0 + oo) + c] = v[c];
        }
      }
    }
    __syncthreads();  // the wing and the kept lanes are the next pass's
  }
  copy_out(fcen + (size_t)cell * cap * 3, fcen_s, 3 * cap);
  if (threadIdx.x < 9) {
    // dh[m][c] = sum over offsets of S_m (sum of the offset's wing_c)
    const int m = threadIdx.x / 3, c = threadIdx.x % 3;
    T acc = T(0);
    if (!interior) {
      for (int o = 0; o < n_off; ++o) {
        const int sm = (tab[o].y >> (2 * m) & 3) - 1;
        if (sm) acc += T(sm) * osum[3 * o + c];
      }
    }
    dh_part[(size_t)cell * 9 + threadIdx.x] = acc;
  }
}

// ---------------------------------------------------------------------------
// Angular kernels: shared parameters and per-center compaction
// ---------------------------------------------------------------------------

template <typename T>
struct AngParams : AngConsts<T> {
  T pi_rca, big;
  T geta, tiny2;  // -eta log2 e and tiny log2 e (the f32 ex2 Gaussians)
  int S, atot;
  int caps[kMaxS], slot0[kMaxS];
  int zeta_floor;  // floor(zeta), for the f32 split power (pair_powers)
  T zeta_frac;     // zeta - floor(zeta)
  int npres, pres[kMaxS];  // the species with caps > 0, ascending
  int pidx[kMaxS];         // species -> its place in pres, or -1
};

constexpr int kDeficitFloor = -(1 << 20);

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

// Compact the staged window win[0, W) in place, in lane order, to its
// lanes of a kept species, each as species | window lane << 4 in sp, by a
// block scan of ballots (wtot: an int a warp); returns how many, the same
// on every thread. A tile's lanes are all read before its barrier and land
// at or below where they were. Every thread calls it; it ends with a
// barrier.
template <typename T>
__device__ __forceinline__ int compact_window(WinLane<T>* win, int W,
                                              int* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int n_kept = 0;
  for (int base = 0; base < W; base += blockDim.x) {
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
    for (int v = 0; v < nw; ++v) {
      if (v < warp) at += wtot[v];
      total += wtot[v];
    }
    if (k) {
      c.sp |= w << 4;
      win[at] = c;
    }
    n_kept += total;
    __syncthreads();
  }
  return n_kept;
}

// The compaction of center a at (cx, cy, cz) on one warp (angular_fwd and
// angular_bwd, so that both keep the same neighbours): the warp reads the
// bin's window, compacted to its n_kept lanes of present species
// (compact_window), 32 lanes at a time, one distance a lane, and ranks each
// present species' in-Rca lanes by popcount with a carry per species, so
// the first caps[s] of species s land in its slots in ascending window lane
// order (the plain version's and the TPU kernel's order). Slot q gets u, d
// (2 Rca + 10 where d <= 1e-6) and fc at s[f A + q], f = 0..4 (the packed
// kernels' field order); with LANES also dfc at f = 5 and its window lane
// in slane[q] (-1: filled at d <= 1e-6). fc and dfc by the hardware cosine
// and sine in f32 (the argument lies in [0, pi]). carry[pi] ends as the
// count of in-Rca lanes of species p.pres[pi], kept or not. FIRST: the
// carry starts at 0; else it goes on from the caller's (the pass forms
// compact the window a pass at a time, in window order).
template <typename T, bool LANES, bool FIRST = true>
__device__ __forceinline__ void compact_slots(const AngParams<T>& p,
                                              const WinLane<T>* win,
                                              int n_kept, int cap, int a,
                                              T cx, T cy, T cz, int lane,
                                              T* s, int* slane,
                                              int (&carry)[kMaxS]) {
  const int A = p.atot;
  const int self_lane = 13 * cap + a;
  const unsigned below = (1u << lane) - 1u;
  if constexpr (FIRST) {
#pragma unroll
    for (int pi = 0; pi < kMaxS; ++pi) carry[pi] = 0;
  }
  for (int base = 0; base < n_kept; base += 32) {
    const int i = base + lane;
    int ws = -1, w = 0;
    T dx = T(0), dy = T(0), dz = T(0), d = T(0);
    if (i < n_kept) {
      const WinLane<T> c = win[i];
      w = c.sp >> 4;
      if (w != self_lane) {
        dx = cx - c.x;
        dy = cy - c.y;
        dz = cz - c.z;
        d = pair_dist(dx, dy, dz);
        if (d <= p.rca) ws = c.sp & 15;
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
      if constexpr (LANES) {
        s[5 * A + q] =
            valid ? (T(-0.5) * p.pi_rca) * sin_0pi(d * p.pi_rca) : T(0);
        slane[q] = valid ? w : -1;
      }
    }
  }
}

__device__ __forceinline__ int triu_index(int s1, int s2, int S) {
  return s1 * S - s1 * (s1 - 1) / 2 + (s2 - s1);
}

// The worst per-species deficit of a center's compaction: count - cap.
template <typename T>
__device__ __forceinline__ int carry_deficit(const AngParams<T>& p,
                                             const int (&carry)[kMaxS]) {
  int dmax = kDeficitFloor;
#pragma unroll
  for (int pi = 0; pi < kMaxS; ++pi)
    if (pi < p.npres) dmax = max(dmax, carry[pi] - p.caps[p.pres[pi]]);
  return dmax;
}

// A center's angular_fwd row orow[AL] from its compacted slots s [5][A]
// (carry: its per-species in-Rca counts), on one warp: per species-pair
// block its live slot pairs spread over the lanes, a reduce-scatter, lane
// l writing channel l; zeros in absent blocks (and on a row whose carry
// is all 0: a slot with no atom).
template <typename T>
__device__ __forceinline__ void af_row(const AngParams<T>& p, const T* s,
                                       const int (&carry)[kMaxS], T* orow,
                                       int lane) {
  const int A = p.atot;
  int b = 0;
  for (int s1 = 0; s1 < p.S; ++s1) {
    for (int s2 = s1; s2 < p.S; ++s2, ++b) {
      const int p1 = p.pidx[s1], p2 = p.pidx[s2];
      const bool same = s1 == s2;
      const int n1 = p1 < 0 ? 0 : min(pick(carry, p1), p.caps[s1]);
      const int n2 = p2 < 0 ? 0 : min(pick(carry, p2), p.caps[s2]);
      const int q = same ? n1 * (n1 - 1) / 2 : n1 * n2;
      T v = T(0);
      if (q > 0) {
        const int off1 = p.slot0[s1], off2 = p.slot0[s2];
        T acc[kNAZ];
#pragma unroll
        for (int i = 0; i < kNAZ; ++i) acc[i] = T(0);
        for (int t = lane; t < q; t += 32) {
          int j, k;
          if (same)
            block_pair<kTri>(t, n1, n1, j, k);
          else
            block_pair<kCross>(t, n1, n2, j, k);
          const int i1 = off1 + j, i2 = off2 + k;
          PairTerms<T> pt;
          pair_terms_geom<T, true, AngParams<T>>(
              p, s[i1], s[A + i1], s[2 * A + i1], s[i2], s[A + i2],
              s[2 * A + i2], s[3 * A + i1], s[3 * A + i2], s[4 * A + i1],
              s[4 * A + i2], pt);
          pair_powers<T>(p, pt);
#pragma unroll
          for (int jj = 0; jj < kNA; ++jj) {
            const T f2 = pt.fc12 * pt.e[jj];
#pragma unroll
            for (int m = 0; m < kNZ; ++m) acc[jj * kNZ + m] += f2 * pt.f1[m];
          }
        }
        reduce_scatter32<T>(acc, lane);
        v = T(2) * acc[0];
      }
      orow[b * kNAZ + lane] = v;
    }
  }
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
// Bound (chip_smoke.py OPS): fp32 instructions and special-function
// results per real candidate of a real center's window, per kept neighbour
// and per slot pair (packed_fwd's), against the bytes of the real rows'
// output; the contract's padded [NC, cap, 896] output (the layout floor)
// is three times those bytes at the roll grid's occupancy.
// Design: one block per bin, kAfWarps warps. The block stages the bin's
// 27-bin window once (stage_window) and compacts it to its lanes of present
// species (compact_window: the empty slots, about two thirds of a roll
// window, are never tested); each warp takes the bin's centers one at a
// time from a shared counter, compacts by ballot (compact_slots, the
// backward's own) into its shared slots (u, d, fc), and walks each present
// species-pair block's live slot pairs only, spread over the lanes as
// asn_packed_fwd_kernel does: the f32 split power (pair_powers) and ex2
// Gaussians, the 32 channel sums in registers, a reduce-scatter of 31
// shuffles in a fixed order, lane l writing channel l. The warp writes
// every entry of the center's row, zeros in absent blocks and on a row
// with no atom, so the wrapper allocates the output without zeroing it.
// The deficit: integer atomicMax into shared memory, then one per block.
// ---------------------------------------------------------------------------
constexpr int kAfWarps = 8;
constexpr int kMaxAngCap = 256;  // the angular hosts' largest grid cap

template <typename T>
size_t af_smem(int cap, int A, int warps) {
  return sizeof(WinLane<T>) * 27 * (size_t)cap +
         sizeof(T) * 5 * (size_t)A * warps;
}

template <typename T>
__global__ void __launch_bounds__(32 * kAfWarps) angular_fwd_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, T* __restrict__ out,
    int* __restrict__ deficit_out, Grid g, AngParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[27];
  __shared__ int next, red, wtot[kAfWarps];
  const int cell = blockIdx.x, cap = g.cap, A = p.atot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WinLane<T>* win = reinterpret_cast<WinLane<T>*>(smem_raw);
  T* s = reinterpret_cast<T*>(win + 27 * cap) + (size_t)warp * 5 * A;
  if (threadIdx.x == 0) {
    next = 0;
    red = kDeficitFloor;
  }
  unsigned keep = 0;
#pragma unroll
  for (int pi = 0; pi < kMaxS; ++pi)
    if (pi < p.npres) keep |= 1u << p.pres[pi];
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  stage_window(pos, sp, h, g, cell, keep, win, tab);
  const int n_kept = compact_window(win, 27 * cap, wtot);
  const int AL = p.S * (p.S + 1) / 2 * kNAZ;
  for (;;) {
    int a = 0;
    if (lane == 0) a = atomicAdd(&next, 1);
    a = __shfl_sync(kFull, a, 0);
    if (a >= cap) break;
    const int me = cell * cap + a;
    T* orow = out + (size_t)me * AL;
    const bool real = sp[me] >= 0;
    int carry[kMaxS];
    if (real) {
      compact_slots<T, false>(p, win, n_kept, cap, a, pos[me * 3],
                              pos[me * 3 + 1], pos[me * 3 + 2], lane, s,
                              nullptr, carry);
      if (lane == 0) atomicMax(&red, carry_deficit(p, carry));
    } else {
#pragma unroll
      for (int pi = 0; pi < kMaxS; ++pi) carry[pi] = 0;
    }
    __syncwarp();
    af_row(p, s, carry, orow, lane);
    __syncwarp();  // the slots are the next center's
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(deficit_out, red);
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
// The block stages the bin's 27-bin window once (stage_window) and compacts
// it to its lanes of present species (compact_window); each warp then
// takes the bin's centers one at a time from a shared counter:
//   * compaction by ballot (compact_slots, the forward's own, so both
//     truncate the same neighbours): the first caps[s] in-Rca lanes of
//     species s in ascending lane order; the slots (u, d, fc, dfc, window
//     lane) go to the warp's shared scratch;
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

// A center `me` of angular_bwd after its compaction (its slots and their
// window lanes in the warp's scratch, carry its per-species counts), on
// one warp: the pair passes, its kept slots' lane cotangents and window
// lanes in res[0, A) (lane -1: no lane), and its fcen.
template <typename T>
__device__ __forceinline__ void bwd_chain(const AngParams<T>& p,
                                          const int (&carry)[kMaxS],
                                          const T* __restrict__ ga,
                                          T* __restrict__ fcen,
                                          WinLane<T>* res,
                                          unsigned char* scratch, int me,
                                          int Q, int lane) {
  const int A = p.atot;
  T* s = reinterpret_cast<T*>(scratch);
  T* o = s + 6 * A;
  T* pb = o + 5 * A;
  T* gsm = pb + 3 * Q;
  int* slane = reinterpret_cast<int*>(gsm + kNAZ);
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

// One center of angular_bwd, on one warp: its fcen, and its kept slots'
// lane cotangents and window lanes in res[0, A) (lane -1: no lane).
template <typename T>
__device__ __forceinline__ void bwd_center(
    const AngParams<T>& p, const Grid& g, const int* csp,
    const T* __restrict__ pos, const T* __restrict__ ga,
    T* __restrict__ fcen, const WinLane<T>* win, int n_kept, WinLane<T>* res,
    unsigned char* scratch, int cell, int a, int Q, int lane) {
  const int cap = g.cap, A = p.atot;
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
  int carry[kMaxS];  // by position in p.pres
  // compaction: the first caps[s] in-Rca lanes of species s, ascending
  __syncwarp();
  compact_slots<T, true>(p, win, n_kept, cap, a, pos[me * 3],
                         pos[me * 3 + 1], pos[me * 3 + 2], lane, s, slane,
                         carry);
  __syncwarp();
  bwd_chain(p, carry, ga, fcen, res, scratch, me, Q, lane);
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
  __shared__ int next, wtot[kBwdMaxWarps];
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
  const int n_kept = compact_window(win, W, wtot);
  for (;;) {
    int a = 0;
    if (lane == 0) a = atomicAdd(&next, 1);
    a = __shfl_sync(kFull, a, 0);
    if (a >= cap) break;
    bwd_center(p, g, csp, pos, ga, fcen, win, n_kept, res + a * A, scratch,
               cell, a, Q, lane);
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
// Angular kernels in passes: the same two functions at grid caps whose
// whole-window layout does not fit a block.
//
// The kernels above stage a bin's 27-bin window in shared memory at once
// (angular_bwd also every center's results, cap A lanes), so their layouts
// outgrow a block above a few hundred slots a bin (207 in f32 for
// angular_bwd at caps H 24 / O 16). The JAX kernels hold the whole window
// in one block of VMEM, which is far larger. Here, as radial_bwd does,
// the block stages the window in passes of whole offsets (the host's
// choice: an x-plane of 9, else an x-y row of 3, else one), compacted to
// its lanes of present species in lane order, and the bin's real centers
// go in rounds, one a warp, in slot order: each warp carries its center's
// compaction from pass to pass (compact_slots without the carry's reset:
// the per-species counts in registers, the kept slots in its scratch), so
// a center's slots are the first caps[s] in-Rca lanes of species s in
// ascending window lane order, the same slots with the same bits as the
// whole window gives. After the last pass each warp runs its center as
// the whole-window kernel does (af_row; bwd_chain). angular_bwd keeps a
// round's results a warp (A lanes), and builds the wing in the bin's own
// slab of the output, which no other block touches: zeroed first, then
// each warp owns a range of window lanes and subtracts the round's results
// in warp order, which is center order, with no atomics, so every wing
// entry is the same sum in the same order as in the whole-window kernel;
// the per-offset sums and the dh partial are read back from that slab.
// The window is staged once a round (the whole-window kernels stage it
// once a bin); the hosts launch these forms only where those do not fit.
// ---------------------------------------------------------------------------

// Dynamic shared memory of the pass forms, byte offsets: a pass's kept
// lanes WinLane [opp cap], the bin's real centers int [cap], then each
// warp's scratch (ang_pass_warp_bytes).
struct PassLayout {
  unsigned ctr, warps;
};

template <typename T>
__host__ __device__ PassLayout pass_layout(int cap, int opp) {
  PassLayout L;
  L.ctr = al16(sizeof(WinLane<T>) * (size_t)opp * cap);
  L.warps = L.ctr + al16(sizeof(int) * (size_t)cap);
  return L;
}

// A warp's scratch in the pass forms: angular_fwd its slots [5][A];
// angular_bwd the whole-window kernel's (bwd_warp_bytes) and its
// center's results WinLane [A].
template <typename T>
__host__ __device__ size_t ang_pass_warp_bytes(bool bwd, int A, int Q) {
  return bwd ? bwd_warp_bytes<T>(A, Q) + sizeof(WinLane<T>) * (size_t)A
             : (size_t)al16(sizeof(T) * 5 * (size_t)A);
}

template <typename T>
size_t ang_pass_smem(bool bwd, int cap, int A, int Q, int opp, int warps) {
  return pass_layout<T>(cap, opp).warps +
         (size_t)warps * ang_pass_warp_bytes<T>(bwd, A, Q);
}

// The 27 window offsets' first grid slots and packed wrap shifts (threads
// below 27) and the bin's real centers in slot order (warp 0), with their
// count; the caller's barrier publishes both.
__device__ __forceinline__ void pass_setup(const Grid& g, int cell,
                                           const int* __restrict__ sp,
                                           int2* tab, int* ctr, int* n_ctr) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 27) {
    int ox, oy, oz, sx, sy, sz;
    offset_of(threadIdx.x, 1, ox, oy, oz);
    const int base = neighbor_bin(g, cell, ox, oy, oz, sx, sy, sz) * g.cap;
    tab[threadIdx.x] = make_int2(base, (sx + 1) | (sy + 1) << 2 |
                                           (sz + 1) << 4);
  }
  if (threadIdx.x < 32) {
    const unsigned below = (1u << lane) - 1u;
    int n = 0;
    for (int b0 = 0; b0 < g.cap; b0 += 32) {
      const bool r = b0 + lane < g.cap && sp[cell * g.cap + b0 + lane] >= 0;
      const unsigned bal = __ballot_sync(kFull, r);
      if (r) ctr[n + __popc(bal & below)] = b0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) *n_ctr = n;
  }
}

// Stage the window offsets [o0, o0 + opp) of a bin (tab: pass_setup's) in
// shared memory, compacted in lane order to the lanes of a species in the
// bit mask `keep`, each as species | window lane << 4, by a block scan of
// ballots (wtot: an int a warp); returns how many, the same on every
// thread. Positions by candidate_pos, as stage_window. Every thread calls
// it; it ends with a barrier.
template <typename T>
__device__ __forceinline__ int stage_pass(const T* __restrict__ pos,
                                          const int* __restrict__ sp,
                                          const T* h, const int2* tab,
                                          int cap, unsigned keep, int o0,
                                          int opp, WinLane<T>* kept,
                                          int* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, PL = opp * cap, w0 = o0 * cap;
  const unsigned below = (1u << lane) - 1u;
  int n_kept = 0;
  for (int base = 0; base < PL; base += blockDim.x) {
    const int lw = base + threadIdx.x;
    WinLane<T> c;
    bool k = false;
    if (lw < PL) {
      const int oo = lw / cap;
      const int2 t = tab[o0 + oo];
      const int q = t.x + (lw - oo * cap);
      const int s = sp[q];
      if (s >= 0 && (keep >> s & 1u)) {
        candidate_pos(pos, q, h, (t.y & 3) - 1, (t.y >> 2 & 3) - 1,
                      (t.y >> 4 & 3) - 1, c.x, c.y, c.z);
        c.sp = s | (w0 + lw) << 4;
        k = true;
      }
    }
    const unsigned bal = __ballot_sync(kFull, k);
    if (lane == 0) wtot[warp] = __popc(bal);
    __syncthreads();
    int at = n_kept + __popc(bal & below), total = 0;
    for (int v = 0; v < nw; ++v) {
      if (v < warp) at += wtot[v];
      total += wtot[v];
    }
    if (k) kept[at] = c;
    n_kept += total;
    __syncthreads();
  }
  return n_kept;
}

template <typename T>
__device__ __forceinline__ unsigned keep_mask(const AngParams<T>& p) {
  unsigned keep = 0;
#pragma unroll
  for (int pi = 0; pi < kMaxS; ++pi)
    if (pi < p.npres) keep |= 1u << p.pres[pi];
  return keep;
}

template <typename T>
__global__ void __launch_bounds__(32 * kAfWarps) angular_fwd_pass_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, T* __restrict__ out,
    int* __restrict__ deficit_out, Grid g, AngParams<T> p, int opp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[27];
  __shared__ int red, n_ctr_s, wtot[kAfWarps];
  const int cell = blockIdx.x, cap = g.cap, A = p.atot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const PassLayout L = pass_layout<T>(cap, opp);
  WinLane<T>* kept = reinterpret_cast<WinLane<T>*>(smem_raw);
  int* ctr = reinterpret_cast<int*>(smem_raw + L.ctr);
  T* s = reinterpret_cast<T*>(smem_raw + L.warps +
                              warp * ang_pass_warp_bytes<T>(false, A, 0));
  if (threadIdx.x == 0) red = kDeficitFloor;
  const unsigned keep = keep_mask(p);
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  pass_setup(g, cell, sp, tab, ctr, &n_ctr_s);
  const int AL = p.S * (p.S + 1) / 2 * kNAZ;
  // the rows of empty slots are zeros
  for (int a = warp; a < cap; a += nw) {
    if (sp[cell * cap + a] >= 0) continue;
    T* orow = out + (size_t)(cell * cap + a) * AL;
    for (int i = lane; i < AL; i += 32) orow[i] = T(0);
  }
  __syncthreads();
  const int n_ctr = n_ctr_s;
  for (int r0 = 0; r0 < n_ctr; r0 += nw) {
    const bool has = r0 + warp < n_ctr;
    const int a = has ? ctr[r0 + warp] : 0;
    const int me = cell * cap + a;
    T cx = T(0), cy = T(0), cz = T(0);
    if (has) {
      cx = pos[me * 3];
      cy = pos[me * 3 + 1];
      cz = pos[me * 3 + 2];
    }
    int carry[kMaxS];
#pragma unroll
    for (int pi = 0; pi < kMaxS; ++pi) carry[pi] = 0;
    for (int o0 = 0; o0 < 27; o0 += opp) {
      const int n_kept =
          stage_pass(pos, sp, h, tab, cap, keep, o0, opp, kept, wtot);
      if (has)
        compact_slots<T, false, false>(p, kept, n_kept, cap, a, cx, cy, cz,
                                       lane, s, nullptr, carry);
      __syncthreads();  // the kept lanes are the next pass's
    }
    if (has) {
      if (lane == 0) atomicMax(&red, carry_deficit(p, carry));
      __syncwarp();
      af_row(p, s, carry, out + (size_t)me * AL, lane);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(deficit_out, red);
}

template <typename T>
__global__ void __launch_bounds__(32 * kBwdMaxWarps) angular_bwd_pass_kernel(
    const T* __restrict__ pos, const int* __restrict__ sp,
    const T* __restrict__ hmat, const T* __restrict__ ga,
    T* __restrict__ fcen, T* __restrict__ wing, T* __restrict__ dh_part,
    Grid g, AngParams<T> p, int Q, int opp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 tab[27];
  __shared__ T osum[27][3];
  __shared__ int n_ctr_s, wtot[kBwdMaxWarps];
  const int cell = blockIdx.x, cap = g.cap, W = 27 * cap, A = p.atot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const PassLayout L = pass_layout<T>(cap, opp);
  const size_t wb = ang_pass_warp_bytes<T>(true, A, Q);
  const size_t res_off = bwd_warp_bytes<T>(A, Q);
  WinLane<T>* kept = reinterpret_cast<WinLane<T>*>(smem_raw);
  int* ctr = reinterpret_cast<int*>(smem_raw + L.ctr);
  unsigned char* scratch = smem_raw + L.warps + warp * wb;
  T* s = reinterpret_cast<T*>(scratch);
  T* o = s + 6 * A;
  int* slane = reinterpret_cast<int*>(o + 5 * A + 3 * Q + kNAZ);
  const unsigned keep = keep_mask(p);
  T h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = hmat[i];
  pass_setup(g, cell, sp, tab, ctr, &n_ctr_s);
  // the bin's wing slab starts at 0; empty slots' fcen is 0
  T* wing_b = wing + (size_t)cell * 3 * W;
  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) wing_b[i] = T(0);
  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x)
    if (sp[cell * cap + i / 3] < 0) fcen[(size_t)cell * cap * 3 + i] = T(0);
  __syncthreads();
  const int n_ctr = n_ctr_s;
  const int per = (W + nw - 1) / nw, lo = warp * per, hi = min(W, lo + per);
  for (int r0 = 0; r0 < n_ctr; r0 += nw) {
    const bool has = r0 + warp < n_ctr;
    const int a = has ? ctr[r0 + warp] : 0;
    const int me = cell * cap + a;
    T cx = T(0), cy = T(0), cz = T(0);
    if (has) {
      cx = pos[me * 3];
      cy = pos[me * 3 + 1];
      cz = pos[me * 3 + 2];
      for (int q = lane; q < A; q += 32) {
        slane[q] = -1;
#pragma unroll
        for (int f = 0; f < 5; ++f) o[f * A + q] = T(0);
      }
    }
    int carry[kMaxS];
#pragma unroll
    for (int pi = 0; pi < kMaxS; ++pi) carry[pi] = 0;
    for (int o0 = 0; o0 < 27; o0 += opp) {
      const int n_kept =
          stage_pass(pos, sp, h, tab, cap, keep, o0, opp, kept, wtot);
      if (has)
        compact_slots<T, true, false>(p, kept, n_kept, cap, a, cx, cy, cz,
                                      lane, s, slane, carry);
      __syncthreads();  // the kept lanes are the next pass's
    }
    if (has)
      bwd_chain(p, carry, ga, fcen,
                reinterpret_cast<WinLane<T>*>(scratch + res_off), scratch,
                me, Q, lane);
    __syncthreads();
    // each warp owns a range of window lanes and subtracts the round's
    // results in warp order (center order)
    const int nv = min(nw, n_ctr - r0);
    for (int v = 0; v < nv; ++v) {
      const WinLane<T>* rv = reinterpret_cast<const WinLane<T>*>(
          smem_raw + L.warps + v * wb + res_off);
      for (int q = lane; q < A; q += 32) {
        const WinLane<T> r = rv[q];
        if (r.sp >= lo && r.sp < hi) {
          wing_b[3 * r.sp] -= r.x;
          wing_b[3 * r.sp + 1] -= r.y;
          wing_b[3 * r.sp + 2] -= r.z;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the results are the next round's, the wing whole
  }
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
      for (int c = 0; c < 3; ++c) v[c] += wing_b[3 * (off * cap + b) + c];
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

// The dynamic shared memory a block of these kernels may take: a block's
// 227 KB less 2 KB for the kernels' static arrays (1,068 B at most, in
// radial_bwd; the two together must fit the 227 KB).
constexpr size_t kDynSmem = 227 * 1024 - 2048;

// The warp count in [1, max_warps] whose shared memory (smem_of(warps)
// bytes a block, at most kDynSmem) lets the most warps reside on an SM
// (228 KB, 1 KB reserved a block; at most 32 blocks and 64 warps; ties:
// more warps a block); 0 if not even one warp fits.
template <typename F>
int best_warps(int max_warps, F smem_of) {
  constexpr size_t kSmPerSm = 228 * 1024, kPerBlock = 1024;
  int warps = 0, best = 0;
  for (int nw = 1; nw <= max_warps; ++nw) {
    const size_t smem = smem_of(nw);
    if (smem > kDynSmem) break;
    const int blocks =
        min((int)(kSmPerSm / (smem + kPerBlock)), min(32, 64 / nw));
    const int resident = nw * blocks;
    if (resident >= best) {
      best = resident;
      warps = nw;
    }
  }
  return warps;
}

// ip: nx ny nz cap shell S NR present; fp: rc eta mu0 delta. A pass stages
// the most window lanes that leave a full SM of blocks of kRfMaxWarps warps
// resident (28,160 B a block: 1,496 lanes in f32 at cap 32, 684 in f64),
// at least 32; every cap up to 256 fits in both dtypes.
template <typename T>
int radial_fwd(const int* ip, const double* fp, const void* pos,
               const void* sp, const void* h, void* out, void* stream) {
  const Grid g = grid_from(ip);
  RfParams<T> p;
  p.shell = ip[4];
  p.S = ip[5];
  p.NR = ip[6];
  p.present = (unsigned)ip[7];
  if (p.NR < 1 || p.NR > kMaxNR || p.S < 1 || p.S > kMaxS || p.shell < 1 ||
      p.shell > 2 || g.cap < 1 || g.cap > 256)
    return cudaErrorInvalidValue;
  const double rc = fp[0], eta = fp[1];
  const bool f32 = std::is_same<T, float>::value;
  p.rc = (T)rc;
  const double rcw = (double)p.rc;
  p.rc2_hi = (T)(rcw * rcw * (1.0 + 1.0 / 1048576.0));
  p.mu0 = (T)fp[2];
  p.delta = (T)fp[3];
  p.pi_rc = (T)(kPi / rc);
  p.geta = (T)(f32 ? -eta * 1.4426950408889634 : -eta);
  const int ns = 2 * p.shell + 1, W = ns * ns * ns * g.cap;
  constexpr size_t kFullSm = 228 * 1024 / (64 / kRfMaxWarps) - 1024;
  const RfLayout L0 = rf_layout<T>(g.cap, 0);
  const size_t fixed = L0.warps + (size_t)kRfMaxWarps * L0.warp_bytes;
  const size_t fit =
      (fixed < kFullSm ? kFullSm - fixed : 0) / sizeof(WinLane<T>);
  p.chunk = fit < 32 ? 32 : fit < (size_t)W ? (int)fit : W;
  auto smem_of = [&](int nw) {
    const RfLayout L = rf_layout<T>(g.cap, p.chunk);
    return (size_t)L.warps + (size_t)nw * L.warp_bytes;
  };
  const int warps = best_warps(kRfMaxWarps, smem_of);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_of(warps);
  cudaError_t err = set_smem(radial_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  radial_fwd_kernel<T><<<g.nx * g.ny * g.nz, 32 * warps, smem,
                         (cudaStream_t)stream>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (T*)out, g, p);
  return (int)cudaGetLastError();
}

template <typename T>
int radial_bwd(const int* ip, const double* fp, const void* pos,
               const void* sp, const void* h, const void* ga, void* fcen,
               void* wing, void* dh_part, void* dh, void* stream) {
  const Grid g = grid_from(ip);
  RbParams<T> p;
  p.shell = ip[4];
  p.S = ip[5];
  p.NR = ip[6];
  p.present = (unsigned)ip[7];
  p.K = kRbStore;
  if (p.NR > kMaxNR || p.S > kMaxS || p.shell < 1 || p.shell > 2 ||
      g.cap < 1 || g.cap > 256)
    return cudaErrorInvalidValue;
  const double rc = fp[0], eta = fp[1];
  const bool f32 = std::is_same<T, float>::value;
  p.rc = (T)rc;
  const double rcw = (double)p.rc;
  p.rc2_hi = (T)(rcw * rcw * (1.0 + 1.0 / 1048576.0));
  p.mu0 = (T)fp[2];
  p.delta = (T)fp[3];
  p.pi_rc = (T)(kPi / rc);
  p.dfc_rk = (T)(-0.5 * kPi / rc);
  p.geta = (T)(f32 ? -eta * 1.4426950408889634 : -eta);
  p.two_eta = T(2) * (T)eta;
  // a pass: an x-plane of the window (ns^2 offsets) where a block of
  // kRbMaxWarps warps holds its layout (every cap the engines size), else
  // an x-y row (ns offsets), else one offset (at cap 256: a row in f64,
  // the plane in f32); each divides the window
  const int ns = 2 * p.shell + 1;
  auto smem_at = [&](int opp, int nw) {
    const RbLayout L = rb_layout<T>(g.cap, p.shell, p.S * p.NR, p.K, opp);
    return (size_t)L.warps + (size_t)nw * L.warp_bytes;
  };
  p.opp = ns * ns;
  while (p.opp > 1 && smem_at(p.opp, kRbMaxWarps) > kDynSmem) p.opp /= ns;
  const int warps =
      best_warps(kRbMaxWarps, [&](int nw) { return smem_at(p.opp, nw); });
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_at(p.opp, warps);
  auto kernel = p.opp == ns * ns ? radial_bwd_kernel<T, true>
                                 : radial_bwd_kernel<T, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = g.nx * g.ny * g.nz;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<nc, 32 * warps, smem, st>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (const T*)ga, (T*)fcen,
      (T*)wing, (T*)dh_part, g, p);
  err = cudaGetLastError();
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
  constexpr double kLog2e = 1.4426950408889634;
  p.geta = (T)(-fp[1] * kLog2e);
  p.tiny2 = (T)(fp[5] * kLog2e);
  const double zf = floor(fp[2]);
  p.zeta_floor = (int)zf;
  p.zeta_frac = (T)(fp[2] - zf);
  p.npres = 0;
  for (int s = 0; s < kMaxS; ++s) {
    p.pres[s] = 0;
    p.pidx[s] = -1;
  }
  for (int s = 0; s < kMaxS; ++s) {
    if (p.caps[s] > 0) {
      p.pidx[s] = p.npres;
      p.pres[p.npres++] = s;
    }
  }
  return true;
}

// The largest grid cap in [0, kMaxAngCap] that `taken(cap)` admits (it
// admits every cap below one it admits).
template <typename F>
int largest_cap(F taken) {
  int lo = 0, hi = kMaxAngCap;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (taken(mid))
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The largest species-pair block's slot pairs (at least 1).
template <typename T>
int max_block_pairs(const AngParams<T>& p) {
  int Q = 1;
  for (int s1 = 0; s1 < p.S; ++s1)
    for (int s2 = s1; s2 < p.S; ++s2) {
      const int q = s1 == s2 ? p.caps[s1] * (p.caps[s1] - 1) / 2
                             : p.caps[s1] * p.caps[s2];
      if (q > Q) Q = q;
    }
  return Q;
}

// The window offsets a block of an angular kernel (bwd: angular_bwd)
// stages a pass at grid cap `cap`: 27 where the whole-window kernel's
// one-warp layout fits (every cap the engines size: today's kernel as
// it was); else the pass form's x-plane (9), x-y row (3) or one offset,
// the first whose layout holds a block of the most warps, else one
// offset if it holds one warp; 0 where the kernel does not take the cap
// (above kMaxAngCap, the radial kernels' limit too, or where even one
// offset and one warp do not fit: the caps' per-warp scratch). `pass`:
// the pass form even where the whole window fits (a check of its walk).
template <typename T>
int ang_form(bool bwd, const AngParams<T>& p, int cap, bool pass) {
  if (cap < 1 || cap > kMaxAngCap) return 0;
  const int A = p.atot, Q = max_block_pairs(p);
  const size_t whole =
      bwd ? bwd_smem<T>(cap, A, Q, 1) : af_smem<T>(cap, A, 1);
  if (!pass && whole <= kDynSmem) return 27;
  const int most = bwd ? kBwdMaxWarps : kAfWarps;
  int opp = 9;
  while (opp > 1 && ang_pass_smem<T>(bwd, cap, A, Q, opp, most) > kDynSmem)
    opp /= 3;
  return ang_pass_smem<T>(bwd, cap, A, Q, opp, 1) <= kDynSmem ? opp : 0;
}

// The largest grid cap an angular kernel's host takes at these caps:
// 256 at the caps the engines size, in both dtypes.
template <typename T>
int angular_cap_limit(bool bwd, const AngParams<T>& p) {
  return largest_cap(
      [&](int cap) { return ang_form<T>(bwd, p, cap, false) > 0; });
}

// ip: nx ny nz cap S zeta_int caps[S] pass; fp: as ang_params.
template <typename T>
int angular_fwd(const int* ip, const double* fp, const void* pos,
                const void* sp, const void* h, void* out, void* deficit,
                void* stream) {
  const Grid g = grid_from(ip);
  AngParams<T> p;
  if (!ang_params(ip, fp, p) || p.zeta_floor < 0)
    return cudaErrorInvalidValue;
  const int opp = ang_form<T>(false, p, g.cap, ip[6 + p.S] != 0);
  if (opp == 0) return cudaErrorInvalidValue;
  const int nc = g.nx * g.ny * g.nz;
  cudaStream_t st = (cudaStream_t)stream;
  if (opp == 27) {
    const int warps = best_warps(
        kAfWarps, [&](int nw) { return af_smem<T>(g.cap, p.atot, nw); });
    if (warps == 0) return cudaErrorInvalidValue;
    const size_t smem = af_smem<T>(g.cap, p.atot, warps);
    cudaError_t err = set_smem(angular_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    angular_fwd_kernel<T><<<nc, 32 * warps, smem, st>>>(
        (const T*)pos, (const int*)sp, (const T*)h, (T*)out, (int*)deficit,
        g, p);
    return (int)cudaGetLastError();
  }
  auto smem_of = [&](int nw) {
    return ang_pass_smem<T>(false, g.cap, p.atot, 0, opp, nw);
  };
  const int warps = best_warps(kAfWarps, smem_of);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_of(warps);
  cudaError_t err = set_smem(angular_fwd_pass_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  angular_fwd_pass_kernel<T><<<nc, 32 * warps, smem, st>>>(
      (const T*)pos, (const int*)sp, (const T*)h, (T*)out, (int*)deficit, g,
      p, opp);
  return (int)cudaGetLastError();
}

template <typename T>
int angular_bwd(const int* ip, const double* fp, const void* pos,
                const void* sp, const void* h, const void* ga, void* fcen,
                void* wing, void* dh_part, void* dh, void* stream) {
  const Grid g = grid_from(ip);
  AngParams<T> p;
  if (!ang_params(ip, fp, p) || p.atot < 1 || p.zeta_floor < 0)
    return cudaErrorInvalidValue;
  const int opp = ang_form<T>(true, p, g.cap, ip[6 + p.S] != 0);
  if (opp == 0) return cudaErrorInvalidValue;
  const int Q = max_block_pairs(p);
  const int nc = g.nx * g.ny * g.nz;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (opp == 27) {
    const int warps = best_warps(kBwdMaxWarps, [&](int nw) {
      return bwd_smem<T>(g.cap, p.atot, Q, nw);
    });
    if (warps == 0) return cudaErrorInvalidValue;
    const size_t smem = bwd_smem<T>(g.cap, p.atot, Q, warps);
    err = set_smem(angular_bwd_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    angular_bwd_kernel<T><<<nc, 32 * warps, smem, st>>>(
        (const T*)pos, (const int*)sp, (const T*)h, (const T*)ga, (T*)fcen,
        (T*)wing, (T*)dh_part, g, p, Q);
  } else {
    auto smem_of = [&](int nw) {
      return ang_pass_smem<T>(true, g.cap, p.atot, Q, opp, nw);
    };
    const int warps = best_warps(kBwdMaxWarps, smem_of);
    if (warps == 0) return cudaErrorInvalidValue;
    const size_t smem = smem_of(warps);
    err = set_smem(angular_bwd_pass_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    angular_bwd_pass_kernel<T><<<nc, 32 * warps, smem, st>>>(
        (const T*)pos, (const int*)sp, (const T*)h, (const T*)ga, (T*)fcen,
        (T*)wing, (T*)dh_part, g, p, Q, opp);
  }
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

// The largest grid cap an angular kernel's host takes, and the window
// offsets its block stages a pass at grid cap ip[3] (ang_form: 27 the
// whole window, 9, 3 or 1 in passes, 0 not taken); ip, fp as the
// kernel's (the pass flag is not read); -1 on invalid parameters.
#define AEV_ROLL_LIMIT(T, SUF)                                               \
  extern "C" int angular_fwd_cap_limit_##SUF(const int* ip,                 \
                                             const double* fp) {            \
    AngParams<T> p;                                                          \
    return ang_params(ip, fp, p) ? angular_cap_limit(false, p) : -1;        \
  }                                                                          \
  extern "C" int angular_bwd_cap_limit_##SUF(const int* ip,                 \
                                             const double* fp) {            \
    AngParams<T> p;                                                          \
    return ang_params(ip, fp, p) ? angular_cap_limit(true, p) : -1;         \
  }                                                                          \
  extern "C" int angular_fwd_form_##SUF(const int* ip, const double* fp) {  \
    AngParams<T> p;                                                          \
    return ang_params(ip, fp, p) ? ang_form(false, p, ip[3], false) : -1;   \
  }                                                                          \
  extern "C" int angular_bwd_form_##SUF(const int* ip, const double* fp) {  \
    AngParams<T> p;                                                          \
    return ang_params(ip, fp, p) ? ang_form(true, p, ip[3], false) : -1;    \
  }

AEV_ROLL_ENTRY(float, f32)
AEV_ROLL_ENTRY(double, f64)
AEV_ROLL_LIMIT(float, f32)
AEV_ROLL_LIMIT(double, f64)

extern "C" const char* aev_roll_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
