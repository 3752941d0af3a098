// Shear-warp DRR kernels for Hopper (sm_90a): the four kernels of the
// registration path, behind a plain C interface loaded with ctypes.
//
//   K1 sw_accumulate          replaces _acc_kernel    (xvr_tpu/render/shearwarp.py:222)
//   K2 sw_warp                replaces _warp_kernel   (xvr_tpu/render/shearwarp.py:368)
//   K3 sw_warp_grads          replaces _warp_grads_kernel (xvr_tpu/render/shearwarp.py:400)
//   K4 sw_accumulate_adjoint  replaces _adj_kernel    (xvr_tpu/render/shearwarp.py:955)
//
// The hat profile hat_eps(x) = clip(((1 + eps)/2 - |x|)/eps, 0, 1) has
// support half-width (1 + eps)/2 <= 1, so in every slab a slope-grid row
// touches at most two voxel rows and a column at most two lanes. The
// geometry is separable: for one image b and slab k, the window position
// wpos = s1 + c (u0 + du i) depends only on the row i, the lane position
// lpos = s2 + c (v0 + dv j) only on the column j, and w_k only on k. So a
// slab's contribution is w_k Hw_k^T S_k Hl_k with two band matrices two taps
// wide. The TPU kernels build both hat matrices densely in VMEM and run two
// MXU products. K1 and K4 here keep the factorisation and drop the dense
// matrices: a block owns a TI x TJ tile of the slope grid of one image and
// walks the slabs in order; per slab it stages the few volume rows and lanes
// the tile touches in shared memory with cp.async (a ring of NS chunks, so
// the next slabs load while this one computes), runs a lane pass (T[w, j] =
// hl0(j) S[w, l0(j)] + hl1(j) S[w, l0(j) + 1]) and then a row pass
// (acc(i, j) += w_k (hw0(i) T[w0(i), j] + hw1(i) T[w0(i) + 1, j])). Column
// hats are computed once per (k, j), row hats once per (k, i), and each T
// entry once per tile, where the first version did all of it per sample.
//
// No tensor cores: each band is two taps wide, so a dense wgmma product of
// the hat matrices would do span/2 times or more useless work, and it would
// need bf16 hat factors, which the f32 checks against the plain versions
// (_accumulate(..., bf16=False)) do not allow. The gain comes from the
// separability, shared memory and the asynchronous copies.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// The hat profile and its slope for one eps, with 1/eps precomputed: for the
// eps the renderers use (1 and 0.25, powers of two) the products below equal
// the plain versions' divisions exactly.
struct Hat {
  float hi, lo, inv;  // (1 + eps)/2, (1 - eps)/2, 1/eps
};

__device__ __forceinline__ Hat make_hat(float eps) {
  return {(1.0f + eps) * 0.5f, (1.0f - eps) * 0.5f, 1.0f / eps};
}

// clip(((1 + eps)/2 - |x|)/eps, 0, 1)
__device__ __forceinline__ float hat_eps(const Hat& h, float x) {
  return fminf(fmaxf((h.hi - fabsf(x)) * h.inv, 0.0f), 1.0f);
}

// d hat/dx: -sign(x)/eps on the ramps (1 - eps)/2 < |x| < (1 + eps)/2.
__device__ __forceinline__ float hat_prime(const Hat& h, float x) {
  const float ax = fabsf(x);
  const bool ramp = (ax > h.lo) && (ax < h.hi);
  const float sg = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  return ramp ? -sg * h.inv : 0.0f;
}

struct SlabParams {
  float s0, s1, s2, sgn, u0, du, v0, dv;
};

// Sample positions are rounded op by op (no fused multiply-add), as the plain
// PyTorch versions compute them: hat' is discontinuous, so a position one ulp
// off can flip a tap of the adjoint. The checks hold K4 to its plain version
// on that basis.
__device__ __forceinline__ float affine_rn(float a, float b, float x) {  // a + b * x
  return __fadd_rn(a, __fmul_rn(b, x));
}

__device__ __forceinline__ SlabParams load_params(const float* __restrict__ params, int b) {
  const float* p = params + 8 * b;
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

// bf16 bits -> f32, exactly
__device__ __forceinline__ float bf16_bits(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// ---------------------------------------------------------------------------
// K1 and K4: the tiled, separable march.
//
// Tiling. One block owns image b and a TI x TJ tile of the slope grid. It
// runs KG warp groups of NT threads, each with its own pipeline, barrier and
// buffers below; group g marches the slabs k with (k - k0) % KG == g, so a
// block keeps KG slabs in flight (the march is bound by the latency of its
// per-slab chain, not by issue: PERF.md). In each group thread (tx, ty) =
// (gt % TJ, gt / TJ) owns column j0 + tx and rows i0 + ty + NTY q, q < RPT,
// and keeps their sums in registers across its slabs; at the end the groups'
// sums are added in group order (no atomics, no split over blocks: the bits
// do not depend on the schedule). Fine stage: B=4, 256^2 grid -> 256 blocks;
// coarse: B=16, 128^2 -> 256 blocks, for 132 SMs.
//
// Plan. For each slab of a window of PLAN slabs, one thread computes w_k and
// the box of volume rows [wlo, whi] and lanes [la, la + npad) that the
// tile's valid samples read. Each position rounds monotonically in i and j,
// so the tile's extremes are at its corner rows and columns. A slab is
// skipped by the whole block when w_k == 0 or the tile's wpos range misses
// [-1, Wd) or its lpos range misses [-1, L), or when the box misses the
// slab's content box (its nonzero rows and lanes, sw_content_boxes): air,
// padding and a label channel outside its label add exactly +0.0, so the
// sums keep their bits. Each block adds the slabs it marched and those it
// skipped for content to the launch's tally. Inside the tile a sample counts
// only if floor(wpos) is in [-1, Wd) (a per-row flag) and floor(lpos) in
// [-1, L) (a per-column flag), as in the plain versions.
//
// Staging. The box is copied row by row into shared memory, STAGE_ROWS rows
// and STAGE_ELEMS bf16 at most per chunk, into a ring of NS chunks whose
// loads run NS - 1 chunks ahead of the compute; a span larger than a chunk
// (steep poses, coarse grids) is walked in several chunks of the same slab,
// so no row is ever dropped. Copies are 4-byte cp.async when L is even and
// the volume 4-byte aligned (lanes start at an even lane), plain loads
// otherwise. A box whose row is wider than a chunk (more than STAGE_ELEMS
// lanes: very wide volumes at steep poses) is not staged: its chunks of
// STAGE_ROWS rows are read by the lane pass straight from global memory, so
// any L works.
//
// Passes. Per slab each thread computes its column's hats, and the threads
// gt < TI of a group their row's. Per chunk the row threads publish (hw0,
// hw1) and the offsets of their two taps' T rows, or of a zero row when a tap
// lies outside the chunk, so the row pass is two shared loads and three FMAs
// per output.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): K1 by bytes, the bf16
// volume read once (33.5 MB at 256^3, ~10 us), its ~8 FLOP per sample below
// that; K4 by operations (~16 FLOP per sample, ~16 us at the fine stage).
// What holds the kernels above it is the latency of each group's per-slab
// chain (two group barriers around dependent shared-memory loads) at 16-24
// warps per SM, and for K4 also its double adds under a 128-register cap
// (PERF.md).
// ---------------------------------------------------------------------------
// The values are the tuned ones (PERF.md). K1 and K4 share the tile and the
// staging; each has its own warp groups (K4's double sums take more
// registers).
constexpr int TI = 16;                 // slope-grid rows per tile
constexpr int TJ = 64;                 // slope-grid columns per tile
constexpr int NS = 4;                  // staged chunks in a group's cp.async ring
constexpr int STAGE_ELEMS = 2048;      // bf16 per staged chunk
constexpr int STAGE_ROWS = 32;         // rows per staged chunk (T's height)
constexpr int TROWS = STAGE_ROWS + 1;  // T's rows and its zero row
static_assert(NS >= 2 && STAGE_ELEMS % 2 == 0, "stages");

template <bool ADJ>
struct Cfg {
  static constexpr int NT = 128;             // threads per warp group
  static constexpr int KG = ADJ ? 2 : 3;     // warp groups (alternate slabs)
  static constexpr int MINB = 2;             // blocks an SM must hold
  static constexpr int NB = NT * KG;         // threads per block
  static constexpr int NTY = NT / TJ;        // thread rows of a group
  static constexpr int RPT = TI / NTY;       // outputs per thread
  static constexpr int PLAN = NB;            // slabs per plan window
  static_assert(NT % 32 == 0 && NB <= 1024 && KG <= 8 && NT % TJ == 0 && TI % NTY == 0 &&
                    TI <= NT && TJ <= NT,
                "tile and groups");
};

template <bool ADJ>
struct Group {  // one warp group's pipeline
  uint16_t stage[NS][STAGE_ELEMS];                   // bf16 boxes, a ring
  alignas(16) float t[(ADJ ? 2 : 1) * TROWS * TJ];   // T, then Tp (K4); row STAGE_ROWS is 0
  float4 row[TI];                                    // hw0, hw1, T offsets of taps 0 and 1
  float2 rowp[TI];                                   // hw0', hw1' (K4)
};

template <bool ADJ>
struct Smem {
  Group<ADJ> g[Cfg<ADJ>::KG];
  int4 box[Cfg<ADJ>::PLAN];                          // (wlo, whi, la, npad)
  float wk[Cfg<ADJ>::PLAN];
  int rpc[Cfg<ADJ>::PLAN];                           // rows per chunk
  // The plan reads these from shared memory, so that the march holds neither
  // in registers (the content test in a register-bound march spilled its
  // per-slab state: PERF.md §6).
  float4 corners;       // the tile's corner positions (ua, ub, va, vb)
  const int4* content;  // the volume's content boxes
  int2 tally;  // slabs marched, skipped for content: past the epilogues' exchange (below)
};

template <bool ADJ>
struct Acc;
template <>
struct Acc<false> {
  float a[Cfg<false>::RPT];
};
template <>
struct Acc<true> {
  double a[Cfg<true>::RPT], b[Cfg<true>::RPT];  // gw and gl terms, before the Ibar factor
};

// The epilogues reuse the whole of Smem: K1 for the groups' sums, K4 for the
// groups' sums and the tile's reduction.
static_assert((Cfg<false>::KG - 1) * Cfg<false>::RPT * Cfg<false>::NT * 4 <= sizeof(Smem<false>),
              "K1 exchange");
static_assert(((Cfg<true>::KG - 1) * 2 * Cfg<true>::RPT * Cfg<true>::NT + TI * (TJ + 1)) * 8 <=
                  sizeof(Smem<true>),
              "K4 exchange");
static_assert((Cfg<false>::KG - 1) * Cfg<false>::RPT * Cfg<false>::NT * 4 <=
                      offsetof(Smem<false>, tally) &&
                  ((Cfg<true>::KG - 1) * 2 * Cfg<true>::RPT * Cfg<true>::NT + TI * (TJ + 1)) * 8 <=
                      offsetof(Smem<true>, tally),
              "the slab tally outlives the exchange");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most NS - 2 groups are pending: the oldest chunk has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
}

// the barrier of warp group GI of N threads: named barrier GI + 1 (barrier 0
// is __syncthreads), or __syncwarp for a group of one warp
template <int GI, int N>
__device__ __forceinline__ void group_sync() {
  if constexpr (N == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(GI + 1), "n"(N) : "memory");
}

// w_k, the box of slab k and its rows per chunk for a tile whose corner
// positions are (ua, ub) and (va, vb); whi = -1 marks a skipped slab. cb is
// the slab's content box (rlo, rhi, llo, lhi): its first and last row and
// lane that hold a nonzero value (lo > hi for a slab of zeros). The box holds
// every tap a sample of the tile reads, so a box that misses the content's
// rows or lanes reads zeros alone: its slab would add +0.0 to every sum, and
// is skipped. The box is not clipped to the content, which would move the
// chunks' boundaries. -> 1 for a marched slab, 2 for one skipped for its
// content alone, 0 for one that w_k or the volume's bounds skip.
__device__ __forceinline__ int plan_slab(const SlabParams& p, int k, float ua, float ub, float va,
                                         float vb, int Wd, int L, int4 cb, int4* box, float* wkp,
                                         int* rpc) {
  const float c = __fsub_rn((float)k, p.s0);
  const float wk = fminf(fmaxf(affine_rn(0.5f, p.sgn, c), 0.0f), 1.0f);
  const float wa = affine_rn(p.s1, c, ua), wb = affine_rn(p.s1, c, ub);
  const float la = affine_rn(p.s2, c, va), lb = affine_rn(p.s2, c, vb);
  const float wmin = floorf(fminf(wa, wb)), wmax = floorf(fmaxf(wa, wb));
  const float lmin = floorf(fminf(la, lb)), lmax = floorf(fmaxf(la, lb));
  int4 bx = make_int4(0, -1, 0, 2);
  int plan = 0;
  if (wk != 0.0f && wmax >= -1.0f && wmin < (float)Wd && lmax >= -1.0f && lmin < (float)L) {
    bx.x = (int)fmaxf(wmin, 0.0f);
    bx.y = (int)fminf(wmax + 1.0f, (float)(Wd - 1));
    bx.z = (int)fmaxf(lmin, 0.0f) & ~1;
    const int lhi = (int)fminf(lmax + 1.0f, (float)(L - 1));
    bx.w = (lhi - bx.z + 2) & ~1;
    const bool miss = bx.y < cb.x || bx.x > cb.y || bx.z + bx.w - 1 < cb.z || bx.z > cb.w;
    bx.y = miss ? -1 : bx.y;
    plan = miss ? 2 : 1;
  }
  *box = bx;
  *wkp = wk;
  *rpc = bx.w > STAGE_ELEMS ? STAGE_ROWS : min(STAGE_ROWS, STAGE_ELEMS / bx.w);
  return plan;
}

// a box too wide to stage: the lane pass reads it from global memory
__device__ __forceinline__ bool unstaged(const int4& bx) { return bx.w > STAGE_ELEMS; }

// A position in a group's sequence of chunks in the window: slab s
// (window-relative), first row wc. s == n past the end.
struct Cursor {
  int s, wc;
};

// the next slab at or after s that warp group GI marches (s % KG == GI) and
// that is not skipped
template <int KG, int GI>
__device__ __forceinline__ int next_slab(const int4* box, int s, int n) {
  s += (GI - s % KG + KG) % KG;
  while (s < n && box[s].y < 0) s += KG;
  return min(s, n);
}

template <int KG, int GI>
__device__ __forceinline__ Cursor first_chunk(const int4* box, int n) {
  const int s = next_slab<KG, GI>(box, 0, n);
  return {s, s < n ? box[s].x : 0};
}

template <int KG, int GI>
__device__ __forceinline__ Cursor next_chunk(const int4* box, const int* rpc, Cursor c, int n) {
  const int wc = c.wc + rpc[c.s];
  if (wc <= box[c.s].y) return {c.s, wc};
  const int s = next_slab<KG, GI>(box, c.s + 1, n);
  return {s, s < n ? box[s].x : 0};
}

// The copy of stage_chunk for an odd L or a misaligned volume: plain loads,
// lanes past L read 0. Out of line: it is rare, and inlined at every call
// site it would crowd the march out of the instruction cache.
__device__ __noinline__ void stage_rows_plain(uint16_t* dst, const uint16_t* __restrict__ src, int nr,
                                              int npad, int la, int L, int warp, int lane, int nw) {
  for (int r = warp; r < nr; r += nw)
    for (int q = lane; q < npad; q += 32)
      dst[r * npad + q] = (la + q < L) ? src[(size_t)r * L + q] : (uint16_t)0;
}

// Copy rows [c.wc, c.wc + nr) x lanes [la, la + npad) of slab kw + c.s into
// dst: one warp of the group per row, one 4-byte word (or bf16) per lane.
template <bool ADJ>
__device__ __forceinline__ void stage_chunk(uint16_t* dst, const Smem<ADJ>& sm,
                                            const uint16_t* __restrict__ vol, int Wd, int L,
                                            int kw, Cursor c, bool pairs, int gt) {
  constexpr int NW = Cfg<ADJ>::NT / 32;
  const int4 bx = sm.box[c.s];
  if (unstaged(bx)) return;
  const int nr = min(sm.rpc[c.s], bx.y - c.wc + 1);
  const int la = bx.z, npad = bx.w;
  const uint16_t* src = vol + ((size_t)(kw + c.s) * Wd + c.wc) * L + la;
  const int warp = gt >> 5, lane = gt & 31;
  if (pairs) {
    for (int r = warp; r < nr; r += NW)
      for (int q = 2 * lane; q < npad; q += 64) cp_async4(dst + r * npad + q, src + (size_t)r * L + q);
  } else {
    stage_rows_plain(dst, src, nr, npad, la, L, warp, lane, NW);
  }
}

// The march of warp group GI over its slabs of [k0, k1) (see the note above).
// Thread 0 adds the window's slab counts to sm.tally (add_tally).
template <bool ADJ, int GI>
__device__ __forceinline__ void march(Smem<ADJ>& sm, Acc<ADJ>& acc, const uint16_t* __restrict__ vol,
                                      int Wd, int L, const SlabParams& p, int Iu, int Iv, float eps,
                                      int k0, int k1, bool pairs) {
  using C = Cfg<ADJ>;
  constexpr int NT = C::NT, KG = C::KG, NTY = C::NTY;
  constexpr int TP = TROWS * TJ;  // Tp's offset in G.t
  Group<ADJ>& G = sm.g[GI];
  const int tid = threadIdx.x, gt = tid - GI * NT, tx = gt % TJ, ty = gt / TJ;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const Hat hat = make_hat(eps);
  const float ua = affine_rn(p.u0, p.du, (float)i0);
  const float ub = affine_rn(p.u0, p.du, (float)(min(i0 + TI, Iu) - 1));
  const float va = affine_rn(p.v0, p.dv, (float)j0);
  const float vb = affine_rn(p.v0, p.dv, (float)(min(j0 + TJ, Iv) - 1));
  const int j = j0 + tx, ir = i0 + gt;  // this thread's column; its row when gt < TI
  const float v = affine_rn(p.v0, p.dv, (float)j);
  const float ur = affine_rn(p.u0, p.du, (float)ir);
  if (gt < TJ) {  // the zero rows the row pass reads for taps outside a chunk
    G.t[STAGE_ROWS * TJ + gt] = 0.0f;
    if (ADJ) G.t[TP + STAGE_ROWS * TJ + gt] = 0.0f;
  }
  if (tid == 0) sm.corners = make_float4(ua, ub, va, vb);  // read after the window's barrier
  for (int kw = k0; kw < k1; kw += C::PLAN) {
    const int n = min(C::PLAN, k1 - kw);
    __syncthreads();  // every group is done with the previous window's plan
    int plan = 0;
    if (tid < n) {
      const float4 cr = sm.corners;
      plan = plan_slab(p, kw + tid, cr.x, cr.y, cr.z, cr.w, Wd, L, sm.content[kw + tid],
                       &sm.box[tid], &sm.wk[tid], &sm.rpc[tid]);
    }
    const int marched = __syncthreads_count(plan == 1);
    const int skipped = __syncthreads_count(plan == 2);
    if (tid == 0) sm.tally = make_int2(sm.tally.x + marched, sm.tally.y + skipped);
    // ring of NS staged chunks: the loads run NS - 1 chunks ahead of the compute
    Cursor ld = first_chunk<KG, GI>(sm.box, n), cu = ld;
    for (int r = 0; r < NS - 1; ++r) {
      if (ld.s < n) {
        stage_chunk<ADJ>(G.stage[r], sm, vol, Wd, L, kw, ld, pairs, gt);
        ld = next_chunk<KG, GI>(sm.box, sm.rpc, ld, n);
      }
      cp_async_commit();
    }
    int slot = 0, cur = -1, l0 = 0, w0 = 0;
    bool lok = false, wok = false;
    float hl0 = 0.0f, hl1 = 0.0f, hp0 = 0.0f, hp1 = 0.0f;  // this thread's column
    float hw0 = 0.0f, hw1 = 0.0f, hwp0 = 0.0f, hwp1 = 0.0f;  // its row (gt < TI)
    while (cu.s < n) {
      const int s = cu.s, wc = cu.wc;
      const int4 bx = sm.box[s];
      const float wk = sm.wk[s];
      const int nr = min(sm.rpc[s], bx.y - wc + 1);
      cp_async_wait_ring();
      group_sync<GI, NT>();  // chunk cu has landed; the last lane and row passes are done
      if (ld.s < n) {        // refill the slot the last lane pass read
        stage_chunk<ADJ>(G.stage[(slot + NS - 1) % NS], sm, vol, Wd, L, kw, ld, pairs, gt);
        ld = next_chunk<KG, GI>(sm.box, sm.rpc, ld, n);
      }
      cp_async_commit();
      if (s != cur) {  // a new slab: the column's hats, and the row's
        cur = s;
        const float c = __fsub_rn((float)(kw + s), p.s0);
        const float lpos = affine_rn(p.s2, c, v);
        const float lf = floorf(lpos);
        lok = j < Iv && lf >= -1.0f && lf < (float)L;
        l0 = (int)lf;
        const float fl = lpos - lf;
        hl0 = lok ? hat_eps(hat, fl) : 0.0f;
        hl1 = lok ? hat_eps(hat, fl - 1.0f) : 0.0f;
        if (ADJ) {
          hp0 = lok ? hat_prime(hat, fl) : 0.0f;
          hp1 = lok ? hat_prime(hat, fl - 1.0f) : 0.0f;
        }
        if (gt < TI) {
          const float wpos = affine_rn(p.s1, c, ur);
          const float wf = floorf(wpos);
          wok = ir < Iu && wf >= -1.0f && wf < (float)Wd;
          w0 = (int)wf;
          const float fw = wpos - wf;
          hw0 = hat_eps(hat, fw);
          hw1 = hat_eps(hat, fw - 1.0f);
          if (ADJ) {
            hwp0 = hat_prime(hat, fw);
            hwp1 = hat_prime(hat, fw - 1.0f);
          }
        }
      }
      if (gt < TI) {  // this chunk's T rows of the row's two taps, or the zero row
        const int r0 = w0 - wc;
        const bool in0 = wok && r0 >= 0 && r0 < nr, in1 = wok && r0 + 1 >= 0 && r0 + 1 < nr;
        G.row[gt] = make_float4(hw0, hw1, __int_as_float((in0 ? r0 : STAGE_ROWS) * TJ),
                                __int_as_float((in1 ? r0 + 1 : STAGE_ROWS) * TJ));
        if (ADJ) G.rowp[gt] = make_float2(hwp0, hwp1);
      }
      // lane pass: T[r, j] (and Tp) for the chunk's rows, whose lane la is
      // at S; lanes -1 and L read 0
      const bool ok0 = lok && l0 >= 0, ok1 = lok && l0 + 1 < L;
      const auto lane_pass = [&](const uint16_t* S, int stride) {
        for (int r = ty; r < nr; r += NTY) {
          const uint16_t* row = S + r * stride;
          const float a = ok0 ? bf16_bits(row[l0]) : 0.0f;
          const float b = ok1 ? bf16_bits(row[l0 + 1]) : 0.0f;
          G.t[r * TJ + tx] = __fmaf_rn(hl1, b, __fmul_rn(hl0, a));
          if (ADJ) G.t[TP + r * TJ + tx] = hp0 * a + hp1 * b;
        }
      };
      if (unstaged(bx))
        lane_pass(vol + ((size_t)(kw + s) * Wd + wc) * L, L);
      else
        lane_pass(G.stage[slot] - bx.z, bx.w);
      group_sync<GI, NT>();
      // row pass
#pragma unroll
      for (int q = 0; q < C::RPT; ++q) {
        const int il = ty + NTY * q;
        const float4 h = G.row[il];
        const int o0 = __float_as_int(h.z) + tx, o1 = __float_as_int(h.w) + tx;
        const float t0 = G.t[o0], t1 = G.t[o1];
        if constexpr (ADJ) {
          const float2 hp = G.rowp[il];
          acc.a[q] += (double)(wk * (hp.x * t0 + hp.y * t1));
          acc.b[q] += (double)(wk * (h.x * G.t[TP + o0] + h.y * G.t[TP + o1]));
        } else {
          acc.a[q] = __fmaf_rn(wk, __fmaf_rn(h.y, t1, __fmul_rn(h.x, t0)), acc.a[q]);
        }
      }
      cu = next_chunk<KG, GI>(sm.box, sm.rpc, cu, n);
      slot = (slot + 1) % NS;
    }
  }
}

// Run the march of this thread's warp group, each group its own
// specialisation (its buffers and barrier at fixed addresses and ids).
template <bool ADJ, int GI = 0>
__device__ __forceinline__ void march_group(int g, Smem<ADJ>& sm, Acc<ADJ>& acc,
                                            const uint16_t* __restrict__ vol, int Wd, int L,
                                            const SlabParams& p, int Iu, int Iv, float eps, int k0,
                                            int k1, bool pairs) {
  if constexpr (GI < Cfg<ADJ>::KG) {
    if (g == GI)
      march<ADJ, GI>(sm, acc, vol, Wd, L, p, Iu, Iv, eps, k0, k1, pairs);
    else
      march_group<ADJ, GI + 1>(g, sm, acc, vol, Wd, L, p, Iu, Iv, eps, k0, k1, pairs);
  }
}

// Thread 0 at the start: the content boxes' pointer into shared memory, and
// the block's slab counts zeroed.
template <bool ADJ>
__device__ __forceinline__ void start_plan(Smem<ADJ>& sm, const int4* __restrict__ content) {
  if (threadIdx.x == 0) {
    sm.content = content;
    sm.tally = make_int2(0, 0);
  }
}

// The block's slab counts (sm.tally), added once to the launch's counters
// (tally[0] marched, tally[1] skipped for content alone) by thread 0 at the
// end.
__device__ __forceinline__ void add_tally(unsigned long long* __restrict__ tally, int2 t) {
  if (t.x) atomicAdd(tally, (unsigned long long)t.x);
  if (t.y) atomicAdd(tally + 1, (unsigned long long)t.y);
}

// K1: I[b, i, j] = sum_k w_k sum_{w,l} hat(wpos - w) hat(lpos - l) S_k[w, l]
// The warp groups' sums of one output are added in group order.
__global__ void __launch_bounds__(Cfg<false>::NB, Cfg<false>::MINB)
    sw_accumulate_tiled_kernel(const uint16_t* __restrict__ vol, int Wd, int L,
                               const int4* __restrict__ content, const float* __restrict__ params,
                               float* __restrict__ out, int Iu, int Iv, float eps, int k0, int k1,
                               bool pairs, unsigned long long* __restrict__ tally) {
  using C = Cfg<false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<false>& sm = *reinterpret_cast<Smem<false>*>(smem_raw);
  const int b = blockIdx.z;
  const int g = threadIdx.x / C::NT, gt = threadIdx.x % C::NT, tx = gt % TJ, ty = gt / TJ;
  const SlabParams p = load_params(params, b);
  Acc<false> acc;
#pragma unroll
  for (int q = 0; q < C::RPT; ++q) acc.a[q] = 0.0f;
  start_plan(sm, content);
  march_group<false>(g, sm, acc, vol, Wd, L, p, Iu, Iv, eps, k0, k1, pairs);
  if (C::KG > 1) {
    float* xch = reinterpret_cast<float*>(smem_raw);  // (KG - 1) x RPT x NT
    __syncthreads();  // every group is done with its buffers
    if (g > 0) {
#pragma unroll
      for (int q = 0; q < C::RPT; ++q) xch[((g - 1) * C::RPT + q) * C::NT + gt] = acc.a[q];
    }
    __syncthreads();
    if (g > 0) return;
    for (int h = 1; h < C::KG; ++h) {
#pragma unroll
      for (int q = 0; q < C::RPT; ++q) acc.a[q] += xch[((h - 1) * C::RPT + q) * C::NT + gt];
    }
  }
  const int j = blockIdx.x * TJ + tx;
#pragma unroll
  for (int q = 0; q < C::RPT; ++q) {
    const int i = blockIdx.y * TI + ty + C::NTY * q;
    if (i < Iu && j < Iv) out[((size_t)b * Iu + i) * Iv + j] = acc.a[q];
  }
  if (threadIdx.x == 0) add_tally(tally, sm.tally);
  // lets K2 launch once every block is here; K2 waits for this grid's
  // completion before it reads anything
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K4: adjoint of K1 with respect to the source position.
//   gw[b, i] = sum_k w_k sum_j Ibar[i, j] sum_{w,l} hat'(wpos - w) hat(lpos - l) S_k[w, l]
//   gl[b, j] = sum_k w_k sum_i Ibar[i, j] sum_{w,l} hat(wpos - w) hat'(lpos - l) S_k[w, l]
// The march above with hat' beside hat on both axes: the lane pass builds
// T (hat) and Tp (hat'), the row pass A += w_k (hw0' T0 + hw1' T1) and
// B += w_k (hw0 Tp0 + hw1 Tp1). The terms are signed and cancel heavily, so
// each slab's term is added into double sums. A tile whose Ibar is all zero
// (outside the view) skips the march. At the end each block adds its groups'
// sums in group order, multiplies by Ibar and reduces gw over its columns
// and gl over its rows, in a fixed order, into one double partial per
// block; sw_sum_partials_kernel sums the partials over the blocks. No
// atomics: two calls give identical bits.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(Cfg<true>::NB, Cfg<true>::MINB)
    sw_adjoint_tiled_kernel(const uint16_t* __restrict__ vol, int Wd, int L,
                            const int4* __restrict__ content, const float* __restrict__ params,
                            const uint16_t* __restrict__ ibar, int Iu, int Iv, float eps, int k0,
                            int k1, bool pairs, double* __restrict__ part_gw,
                            double* __restrict__ part_gl, unsigned long long* __restrict__ tally) {
  using C = Cfg<true>;
  constexpr int NT = C::NT, KG = C::KG, RPT = C::RPT, NTY = C::NTY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<true>& sm = *reinterpret_cast<Smem<true>*>(smem_raw);
  const int tid = threadIdx.x, g = tid / NT, gt = tid % NT, tx = gt % TJ, ty = gt / TJ;
  const int b = blockIdx.z, i0 = blockIdx.y * TI, j = blockIdx.x * TJ + tx;
  float ib[RPT];
  bool any = false;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = i0 + ty + NTY * q;
    ib[q] = (i < Iu && j < Iv) ? bf16_bits(ibar[((size_t)b * Iu + i) * Iv + j]) : 0.0f;
    any = any || ib[q] != 0.0f;
  }
  Acc<true> acc;
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc.a[q] = acc.b[q] = 0.0;
  start_plan(sm, content);
  if (__syncthreads_or(any)) {
    const SlabParams p = load_params(params, b);
    march_group<true>(g, sm, acc, vol, Wd, L, p, Iu, Iv, eps, k0, k1, pairs);
  }
  // the groups' sums, added in group order, times Ibar; then the tile's
  // reduction, in the shared memory the pipelines no longer need
  double* xch = reinterpret_cast<double*>(smem_raw);  // (KG - 1) x 2 RPT x NT
  double* red = xch + (KG - 1) * 2 * RPT * NT;        // TI x (TJ + 1)
  __syncthreads();
  if (g > 0) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      xch[((g - 1) * 2 * RPT + q) * NT + gt] = acc.a[q];
      xch[((g - 1) * 2 * RPT + RPT + q) * NT + gt] = acc.b[q];
    }
  }
  __syncthreads();
  double gl = 0.0;
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      double a = acc.a[q], c = acc.b[q];
      for (int h = 1; h < KG; ++h) {
        a += xch[((h - 1) * 2 * RPT + q) * NT + gt];
        c += xch[((h - 1) * 2 * RPT + RPT + q) * NT + gt];
      }
      red[(ty + NTY * q) * (TJ + 1) + tx] = a * (double)ib[q];
      gl += c * (double)ib[q];
    }
  }
  __syncthreads();
  if (tid < TI && i0 + tid < Iu) {
    double s = 0.0;
    for (int t = 0; t < TJ; ++t) s += red[tid * (TJ + 1) + t];
    part_gw[((size_t)b * Iu + i0 + tid) * gridDim.x + blockIdx.x] = s;
  }
  __syncthreads();
  if (g == 0) red[ty * (TJ + 1) + tx] = gl;
  __syncthreads();
  const int jr = blockIdx.x * TJ + tid;
  if (tid < TJ && jr < Iv) {
    double s = 0.0;
    for (int t = 0; t < NTY; ++t) s += red[t * (TJ + 1) + tid];
    part_gl[((size_t)b * Iv + jr) * gridDim.y + blockIdx.y] = s;
  }
  if (tid == 0) add_tally(tally, sm.tally);
}

// out[r] = sum_t part[r, t] for n rows of nt partials.
__global__ void sw_sum_partials_kernel(const double* __restrict__ part, float* __restrict__ out,
                                       int n, int nt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  double s = 0.0;
  for (int t = 0; t < nt; ++t) s += part[(size_t)r * nt + t];
  out[r] = (float)s;
}

// ---------------------------------------------------------------------------
// The content boxes K1 and K4 skip by (plan_slab): for each of n slabs of Wd
// rows x L lanes, the first and last row and the first and last lane that
// hold a nonzero bf16 value, as int4 (rlo, rhi, llo, lhi); (Wd, -1, L, -1)
// for a slab of zeros. A value is nonzero when its bits other than the sign
// are (-0.0 is zero). One block per slab reads it once, 8 lanes a 16-byte
// load when L % 8 == 0 and the volume is 16-byte aligned, else one bf16 a
// load; bound by bytes (the trainer's 8-channel stack at 512^3: 2.1 GB).
// ---------------------------------------------------------------------------
constexpr int CB_THREADS = 512;

// bits 0 and 1: whether the low and the high bf16 of a word are nonzero
__device__ __forceinline__ unsigned nonzero_pair(unsigned w) {
  return (unsigned)((w & 0x7fffu) != 0u) | ((unsigned)((w & 0x7fff0000u) != 0u) << 1);
}

__global__ void __launch_bounds__(CB_THREADS)
    sw_content_boxes_kernel(const uint16_t* __restrict__ vol, int Wd, int L,
                            int4* __restrict__ boxes, bool vec) {
  const uint16_t* slab = vol + (size_t)blockIdx.x * Wd * L;
  int rlo = Wd, rhi = -1, llo = L, lhi = -1;
  if (vec) {
    const int nq = L / 8, n = Wd * nq;
    const uint4* q = reinterpret_cast<const uint4*>(slab);
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += CB_THREADS) {
      const uint4 x = __ldg(q + e);
      const unsigned m = nonzero_pair(x.x) | nonzero_pair(x.y) << 2 | nonzero_pair(x.z) << 4 |
                         nonzero_pair(x.w) << 6;
      if (m) {
        const int r = e / nq, l = (e - r * nq) * 8;
        rlo = min(rlo, r);
        rhi = max(rhi, r);
        llo = min(llo, l + __ffs(m) - 1);
        lhi = max(lhi, l + 31 - __clz(m));
      }
    }
  } else {
    const int n = Wd * L;
    for (int e = threadIdx.x; e < n; e += CB_THREADS) {
      if (__ldg(slab + e) & 0x7fffu) {
        const int r = e / L, l = e - r * L;
        rlo = min(rlo, r);
        rhi = max(rhi, r);
        llo = min(llo, l);
        lhi = max(lhi, l);
      }
    }
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  llo = __reduce_min_sync(0xffffffffu, llo);
  lhi = __reduce_max_sync(0xffffffffu, lhi);
  __shared__ int4 part[CB_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = make_int4(rlo, rhi, llo, lhi);
  __syncthreads();
  if (threadIdx.x == 0) {
    int4 bx = part[0];
    for (int w = 1; w < CB_THREADS / 32; ++w) {
      bx.x = min(bx.x, part[w].x);
      bx.y = max(bx.y, part[w].y);
      bx.z = min(bx.z, part[w].z);
      bx.w = max(bx.w, part[w].w);
    }
    boxes[blockIdx.x] = bx;
  }
}

// ---------------------------------------------------------------------------
// K2/K3: bilinear sample of the slope image at (uc, vc). A sample is valid
// only when -1 < uc < Iu, 0 <= vc <= Iv - 1 and ws > 0. Rows z in
// {floor(uc), floor(uc) + 1} inside [0, Iu) carry the tent weight
// max(1 - |uc - z|, 0); the lane index is clipped to [0, Iv - 2] and its
// fraction to [0, 1], as in the TPU kernel.
//
// Bound on the H100: bytes. Each pixel reads 3 f32 fields and 4 image values
// and writes 1 (K3: 3) f32; the image (<= 1 MB per pose) stays in L2. At the
// registration's shapes (14,400 to 228,484 pixels) that is 0.2-1.4 us, about
// what one launch and one chain of dependent loads take, so the kernels are
// latency- and launch-bound: what counts is how many loads each thread has
// in flight and that every SM has blocks.
//
// Design. K2 and K3 share one body, warp_pixels<GRADS, P>. The (B, R) fields
// are walked flat: thread t owns the P consecutive pixels [tP, tP + P) of the
// B R, which may straddle images. It reads each field by one P-wide vector
// load (float4 for P = 4) when every field and output pointer is 4P-byte
// aligned, computes every pixel's taps, issues all 4P gathers, then finishes
// each pixel with the first version's arithmetic, in the same order (so the
// bits do not change), and stores by vector. Pixels of the last thread that
// run past B R, and every pixel of a call with a misaligned pointer, take
// scalar loads and stores. The launch plan (threads per block, P) is the
// caller's (render/_cuda.py warp_plan, tested on the CPU): one pixel per
// thread, in blocks small enough that every SM has one, up to the 57,600
// pixels of the coarse sweep; P = 2 (K2) or 4 (K3) at the fine stage.
//
// K2 is launched as a programmatic dependent of the kernel before it: K1
// triggers after its last store, so K2's launch overlaps K1's tail; K2 waits
// for the previous grid's completion before it reads anything, so it is right
// after any kernel. (Staging each block's box of the slope image in shared
// memory, as the TPU kernel's windowed gather does, ran 1.7-2.7x slower:
// PERF.md §6.)
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool warp_valid(float u, float v, float w, int Iu, int Iv) {
  return (u > -1.0f) && (u < (float)Iu) && (v >= 0.0f) && (v <= (float)(Iv - 1)) && (w > 0.0f);
}

// P consecutive fields by one vector load (read-only path)
template <int P>
__device__ __forceinline__ void load_pixels(const float* __restrict__ p, float (&x)[P]) {
  if constexpr (P == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (P == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int P>
__device__ __forceinline__ void store_pixels(float* __restrict__ p, const float (&x)[P]) {
  if constexpr (P == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (P == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

// One pixel's taps: its lane fraction, rows z0 and z0 + 1, lane idx and the
// step to its second lane (0 or 1), and which rows lie in [0, Iu).
struct WarpTap {
  float fx;
  int z0, idx, step;
  bool ok, in0, in1;
};

__device__ __forceinline__ WarpTap warp_tap(float u, float v, float w, int Iu, int Iv) {
  WarpTap t;
  t.ok = warp_valid(u, v, w, Iu, Iv);
  int idx = t.ok ? (int)v : 0;  // v >= 0 here, so truncation is floor
  const int idx_max = Iv > 1 ? Iv - 2 : 0;
  idx = min(max(idx, 0), idx_max);
  t.idx = idx;
  t.step = min(idx + 1, Iv - 1) - idx;
  t.fx = fminf(fmaxf(v - (float)idx, 0.0f), 1.0f);
  t.z0 = t.ok ? (int)floorf(u) : 0;
  t.in0 = t.ok && t.z0 >= 0 && t.z0 < Iu;
  t.in1 = t.ok && t.z0 + 1 >= 0 && t.z0 + 1 < Iu;
  return t;
}

// The first version's per-pixel arithmetic on gathered values: rows z0 + d
// in [0, Iu) add their tent-weighted lane interpolation (and K3's partials).
__device__ __forceinline__ void warp_finish(const WarpTap& t, float u, const float (&lo)[2],
                                            const float (&hi)[2], float* val, float* dval_du,
                                            float* dval_dv) {
  const bool in[2] = {t.in0, t.in1};
  float acc = 0.0f, dua = 0.0f, dva = 0.0f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if (!in[d]) continue;
    const int z = t.z0 + d;
    const float diff = u - (float)z;
    const float wz = fmaxf(1.0f - fabsf(diff), 0.0f);
    const float dz = (fabsf(diff) < 1.0f) ? ((diff > 0.0f) ? -1.0f : ((diff < 0.0f) ? 1.0f : 0.0f)) : 0.0f;
    const float val_z = lo[d] + t.fx * (hi[d] - lo[d]);
    acc += wz * val_z;
    dua += dz * val_z;
    dva += wz * (hi[d] - lo[d]);
  }
  *val = acc;
  *dval_du = dua;
  *dval_dv = dva;
}

// K2 (GRADS false): out0 = bilerp * ws. K3: out0, out1, out2 = bilerp and its
// partials in uc and vc (ws only masks). Thread t: pixels [tP, tP + P) of N.
template <bool GRADS, int P>
__device__ __forceinline__ void warp_pixels(const float* __restrict__ I, const float* __restrict__ uc,
                                            const float* __restrict__ vc, const float* __restrict__ ws,
                                            float* __restrict__ out0, float* __restrict__ out1,
                                            float* __restrict__ out2, int Iu, int Iv, int R, int N,
                                            bool vec) {
  if constexpr (!GRADS) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int o0 = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const bool full = vec && o0 + P <= N;
  float u[P], v[P], w[P];
  if (full) {
    load_pixels<P>(uc + o0, u);
    load_pixels<P>(vc + o0, v);
    load_pixels<P>(ws + o0, w);
  } else {  // the tail, or a misaligned call; pixels past N are invalid (ws 0)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool in = o0 + p < N;
      u[p] = in ? __ldg(uc + o0 + p) : 0.0f;
      v[p] = in ? __ldg(vc + o0 + p) : 0.0f;
      w[p] = in ? __ldg(ws + o0 + p) : 0.0f;
    }
  }
  // every pixel's taps and its image's offset (one more image each time the
  // pixel index passes an image's end: R >= 1)
  WarpTap t[P];
  int base[P];
  int b = o0 / R, b_end = (b + 1) * R;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (o0 + p >= b_end) {
      ++b;
      b_end += R;
    }
    t[p] = warp_tap(u[p], v[p], w[p], Iu, Iv);
    base[p] = b * Iu * Iv;
  }
  // all 4P gathers before any use
  float lo[P][2], hi[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float* r0 = I + base[p] + t[p].z0 * Iv + t[p].idx;
    const float* r1 = r0 + Iv;
    lo[p][0] = t[p].in0 ? __ldg(r0) : 0.0f;
    hi[p][0] = t[p].in0 ? __ldg(r0 + t[p].step) : 0.0f;
    lo[p][1] = t[p].in1 ? __ldg(r1) : 0.0f;
    hi[p][1] = t[p].in1 ? __ldg(r1 + t[p].step) : 0.0f;
  }
  float r0[P], r1[P], r2[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    warp_finish(t[p], u[p], lo[p], hi[p], &r0[p], &r1[p], &r2[p]);
    if (!GRADS) r0[p] = t[p].ok ? r0[p] * w[p] : 0.0f;
  }
  if (full) {
    store_pixels<P>(out0 + o0, r0);
    if (GRADS) {
      store_pixels<P>(out1 + o0, r1);
      store_pixels<P>(out2 + o0, r2);
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (o0 + p >= N) continue;
      out0[o0 + p] = r0[p];
      if (GRADS) {
        out1[o0 + p] = r1[p];
        out2[o0 + p] = r2[p];
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(256)
    sw_warp_kernel(const float* __restrict__ I, const float* __restrict__ uc,
                   const float* __restrict__ vc, const float* __restrict__ ws,
                   float* __restrict__ out, int Iu, int Iv, int R, int N, bool vec) {
  warp_pixels<false, P>(I, uc, vc, ws, out, nullptr, nullptr, Iu, Iv, R, N, vec);
}

template <int P>
__global__ void __launch_bounds__(256)
    sw_warp_grads_kernel(const float* __restrict__ I, const float* __restrict__ uc,
                         const float* __restrict__ vc, const float* __restrict__ ws,
                         float* __restrict__ out, float* __restrict__ dout_du,
                         float* __restrict__ dout_dv, int Iu, int Iv, int R, int N, bool vec) {
  warp_pixels<true, P>(I, uc, vc, ws, out, dout_du, dout_dv, Iu, Iv, R, N, vec);
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// Launch K2 (GRADS false) or K3 on `threads` x P pixels per block; K2 as a
// programmatic dependent of the previous kernel.
template <bool GRADS>
int launch_warp(const void* I, const void* uc, const void* vc, const void* ws, void* out,
                void* dout_du, void* dout_dv, int B, int Iu, int Iv, int R, int threads, int P,
                void* stream) {
  const long long N = (long long)B * R, per_block = (long long)threads * P;
  if ((P != 1 && P != 2 && P != 4) || threads < 32 || threads > 256 || threads % 32 != 0 ||
      B < 1 || R < 1 || Iu < 1 || Iv < 1 || N + per_block > INT_MAX ||
      (long long)(B + P) * R > INT_MAX || (long long)(B + P) * Iu * Iv > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int a = 4 * P;
  const bool vec = aligned(uc, a) && aligned(vc, a) && aligned(ws, a) && aligned(out, a) &&
                   (!GRADS || (aligned(dout_du, a) && aligned(dout_dv, a)));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + per_block - 1) / per_block));
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = GRADS ? 0 : 1;
  const float *i_ = (const float*)I, *u_ = (const float*)uc, *v_ = (const float*)vc,
              *w_ = (const float*)ws;
  float *o_ = (float*)out, *du_ = (float*)dout_du, *dv_ = (float*)dout_dv;
  const int n = (int)N;
  if constexpr (GRADS) {
    auto k = P == 4 ? sw_warp_grads_kernel<4> : P == 2 ? sw_warp_grads_kernel<2> : sw_warp_grads_kernel<1>;
    cudaLaunchKernelEx(&cfg, k, i_, u_, v_, w_, o_, du_, dv_, Iu, Iv, R, n, vec);
  } else {
    auto k = P == 4 ? sw_warp_kernel<4> : P == 2 ? sw_warp_kernel<2> : sw_warp_kernel<1>;
    cudaLaunchKernelEx(&cfg, k, i_, u_, v_, w_, o_, Iu, Iv, R, n, vec);
  }
  return (int)cudaGetLastError();
}

bool pairs_ok(const void* vol, int L) { return L % 2 == 0 && (uintptr_t)vol % 4 == 0; }

}  // namespace

extern "C" {

// K1 and K4 take the volume's content boxes (M int4, from sw_content_boxes;
// indexed by slab) and add their blocks' slab counts to tally (2 uint64:
// marched, skipped for content alone).
int sw_accumulate(const void* vol, int Wd, int L, const void* content, const void* params,
                  void* out, int B, int Iu, int Iv, float eps, int k0, int k1, void* tally,
                  void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sw_accumulate_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<false>));
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Iv + TJ - 1) / TJ, (Iu + TI - 1) / TI, B);
  sw_accumulate_tiled_kernel<<<grid, Cfg<false>::NB, sizeof(Smem<false>), (cudaStream_t)stream>>>(
      (const uint16_t*)vol, Wd, L, (const int4*)content, (const float*)params, (float*)out, Iu, Iv,
      eps, k0, k1, pairs_ok(vol, L), (unsigned long long*)tally);
  return (int)cudaGetLastError();
}

// The content boxes of n slabs of Wd x L bf16 into boxes (n int4).
int sw_content_boxes(const void* vol, int n, int Wd, int L, void* boxes, void* stream) {
  if (n < 1 || Wd < 1 || L < 1 || (long long)Wd * L > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = L % 8 == 0 && (uintptr_t)vol % 16 == 0;
  sw_content_boxes_kernel<<<n, CB_THREADS, 0, (cudaStream_t)stream>>>((const uint16_t*)vol, Wd, L,
                                                                      (int4*)boxes, vec);
  return (int)cudaGetLastError();
}

// K2 and K3 with the launch plan of render/_cuda.py warp_plan: `threads` per
// block, P (1, 2 or 4) pixels per thread; dout_du and dout_dv may be views of
// one (3, B, R) buffer with out.
int sw_warp(const void* I, const void* uc, const void* vc, const void* ws, void* out, int B, int Iu,
            int Iv, int R, int threads, int P, void* stream) {
  return launch_warp<false>(I, uc, vc, ws, out, nullptr, nullptr, B, Iu, Iv, R, threads, P, stream);
}

int sw_warp_grads(const void* I, const void* uc, const void* vc, const void* ws, void* out,
                  void* dout_du, void* dout_dv, int B, int Iu, int Iv, int R, int threads, int P,
                  void* stream) {
  return launch_warp<true>(I, uc, vc, ws, out, dout_du, dout_dv, B, Iu, Iv, R, threads, P, stream);
}

// Partials scratch (float64): part_gw (B, Iu, ceil(Iv/TJ)), part_gl (B, Iv, ceil(Iu/TI)).
int sw_adjoint_partials_shape(int Iu, int Iv, int* nbx, int* nby) {
  *nbx = (Iv + TJ - 1) / TJ;
  *nby = (Iu + TI - 1) / TI;
  return 0;
}

int sw_accumulate_adjoint(const void* vol, int Wd, int L, const void* content, const void* params,
                          const void* ibar, void* part_gw, void* part_gl, void* gw, void* gl, int B,
                          int Iu, int Iv, float eps, int k0, int k1, void* tally, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sw_adjoint_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<true>));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((Iv + TJ - 1) / TJ, (Iu + TI - 1) / TI, B);
  sw_adjoint_tiled_kernel<<<grid, Cfg<true>::NB, sizeof(Smem<true>), st>>>(
      (const uint16_t*)vol, Wd, L, (const int4*)content, (const float*)params,
      (const uint16_t*)ibar, Iu, Iv, eps, k0, k1, pairs_ok(vol, L), (double*)part_gw,
      (double*)part_gl, (unsigned long long*)tally);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int nw = B * Iu, nl = B * Iv;
  sw_sum_partials_kernel<<<(nw + 255) / 256, 256, 0, st>>>((const double*)part_gw, (float*)gw, nw,
                                                          (int)grid.x);
  err = (int)cudaGetLastError();
  if (err) return err;
  sw_sum_partials_kernel<<<(nl + 255) / 256, 256, 0, st>>>((const double*)part_gl, (float*)gl, nl,
                                                          (int)grid.y);
  return (int)cudaGetLastError();
}

}  // extern "C"
