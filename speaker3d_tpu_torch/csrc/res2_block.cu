// One BN-folded, inference-only ERes2NetV2 Res2 block (scale 2, no AFF) for
// Hopper (sm_90a), NCHW activations, in two instantiations of one kernel:
// fp32 (every contraction on the tensor cores in 3xTF32, which is as close
// as fp32 FMA) and bf16 (the TPU kernel's serving dtype: bf16 operands,
// mma.sync.m16n8k16 BF16 products with fp32 accumulation).
//
// Replaces the TPU kernel speaker3d_tpu/ops/pallas/res2_block_kernel.py
// (_make_kernel with _conv3x3_hybrid, launched by res2_block_fused). Per
// output position, with every BatchNorm folded into the conv before it:
//
//   h   = relu20(W1 @ x + b1)                 1x1, Cin -> 2w (stride s)
//   y1  = relu20(conv3x3(h[:w]) + bc1)        zero padding in F and T
//   y2  = relu20(conv3x3(h[w:] + y1) + bc2)
//   out = relu20(W3 @ [y1; y2] + b3 + res)    res = Wsc @ x (the shortcut
//                                             BN's bias is in b3) or x itself
//
// with relu20 = Hardtanh(0, 20). Stride 2 reads the even rows and columns of x
// inside the kernel (the reference's 1x1 stride-2 convs do the same). The
// block touches device memory once for x (plus the halo that neighbouring
// tiles share through L2) and once for out, as the TPU kernel does.
//
// The bf16 instantiation rounds where the TPU kernel does (its
// res2_block_fused with a bf16 x): h, y1, u = s2 + y1 (a bf16 sum, rounded
// before the second 3x3 reads it), y2 and out are stored as bf16; every
// product accumulates in fp32 and the biases are added in fp32; the
// identity shortcut adds x up-cast to fp32. Its weights are bf16, folded in
// fp32 and rounded once.
//
// What bounds it on the H100: operations. The path asks for fp32 results
// (TF32 off), and one TF32 pass is ~4e-3 off on a 3x3 conv. 3xTF32 keeps
// fp32-level error: a = a_b + a_s with a_b = rna_tf32(a), a_s = rna_tf32(a -
// a_b), and a*b ~ a_s*b_b + a_b*b_s + a_b*b_b (the small cross terms first),
// each an mma.sync.m16n8k8 TF32 product with fp32 accumulation. At 495 TFLOP/s
// dense TF32 that is 165 TFLOP/s of fp32-accurate work: the 7 launches of one
// [64, 48000] embed batch (574 GFLOP) are bound at ~3.5 ms by operations,
// against ~2.2 ms for their bytes at 3.35 TB/s. mma.sync issues below the
// dense TF32 peak that wgmma reaches, so this design's ceiling is higher.
// In bf16 the same 574 GFLOP are one pass at 989 TFLOP/s dense (~0.6 ms)
// against ~1.1 ms for their (half as many) bytes: bytes bound the bf16
// launches but for the stride-2 entry blocks, and this design (mma.sync,
// one block an SM) stays far from either bound (~5% of it).
//
// Design:
// - Products. M = output positions (16 per m-tile), N = output channels (8 per
//   n-tile), K = input channels, or taps x channels for the 3x3 convs, in
//   k-steps of 8 (TF32) or 16 (BF16). Each
//   stage runs in rounds: warp w holds SLOTS = 2 units of one m-tile x up to
//   NTW = 8 n-tiles (64 accumulators a lane, started at the bias), so one A
//   fragment feeds up to 24 mma. conv1 and conv2 take one round, so their
//   outputs may overwrite their inputs' planes.
// - Weights are split and packed once, at fold time (the wrapper's
//   fold_res2_block): K and N zero-padded to multiples of 8, each 8 x 8
//   (k-step, n-tile) B fragment stored as 32 float4s in lane order (b0 big,
//   b1 big, b0 small, b1 small). A round streams its n-tiles' fragments
//   chunk by chunk into shared memory with cp.async (two buffers of 8 or 16
//   KB, chunk c + 1 in flight while chunk c is multiplied), shared by all 16
//   warps, and a lane reads a fragment with one conflict-free 16-byte load.
//   A fragments are split in registers as they are loaded.
// - Activations stay in shared memory, channel-major, each plane padded to a
//   stride S = 8 (mod 16): an A fragment's lanes run over 8 positions (g) and
//   4 channels (t), and t*S mod 32 is 0, 8, 16, 24, so its loads are free of
//   bank conflicts. The 3x3 convs are implicit im2col: K runs across the
//   nine taps (k = tap*w + c, padded from 9w = 234 to 240 at w = 26, 2.6%,
//   and from 468 to 472 at w = 52, 0.9%), each k mapped to its shared-memory
//   offset by a per-block table; padded k read a real element times a zero
//   weight. x (the expand and the shortcut) is staged per chunk too: kx =
//   1-4 k-steps of channels at the stage's positions, by coalesced loads
//   (zero outside the image; stride 2 read here).
// - BF16. Weights are packed per (k-step of 16, n-tile) as 32 lanes x two
//   registers of two bf16 (pack_b_bf16), read with one 8-byte load. An A
//   register holds two consecutive k, which are two channels (two planes)
//   of one position: two 2-byte loads. K pads 9w to 240 at w = 26 and to
//   480 at w = 52. The planes take half the bytes, so the same tiles fit
//   with room to spare.
// - Tile. A block owns tf x tt output positions of one batch row and all
//   channels: s1 = h[:w] over a +-2 halo, u = h[w:] + y1 over +-1, then y1
//   over s1's planes and y2 over u's. The expand computes both halves over
//   +-2 in one pass over x where one round holds it (2w <= 64), else s1 over
//   +-2 and s2 over +-1 (recompute 1.41x at 16 x 16 against 1.88x when both
//   are at +-2). The launch (pick_geom) picks the tile per shape from {16 x
//   16, 8 x 32} by the work its halos and ragged edges cost among the tiles
//   whose shared memory fits (supported): 16 x 16 at F = 80 (w = 26),
//   8 x 32 at F = 40 (w = 52); 8 x 16 where neither fits (w = 64 with
//   Cout = 256). A block takes up to 232 KB of shared memory:
//   one block of 16 warps per SM, at the 128 registers a thread may have; `build.build(verbose=True)`
//   prints the spills. Most of the time goes to stalls spread over the
//   stages (staging, barriers, epilogues), not to the mma.
//
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using s3d::cp_async16;
using s3d::cp_async_commit;
using s3d::cp_async_wait1;
using s3d::mma;
using s3d::split;

// The two instantiations: the activations' element (fp32, or bf16 bits), K
// per mma k-step, float4 of packed B per (k-step, n-tile), and the element's
// load to fp32 and store from fp32 (round to nearest even).
struct F32 {
  using T = float;
  static constexpr bool IS_BF16 = false;
  static constexpr int KS = 8;
  static constexpr int QK = 32;
  static __device__ __forceinline__ float ld(T v) { return v; }
  static __device__ __forceinline__ T st(float v) { return v; }
};

struct BF16 {
  using T = uint16_t;
  static constexpr bool IS_BF16 = true;
  static constexpr int KS = 16;
  static constexpr int QK = 16;
  static __device__ __forceinline__ float ld(T v) { return s3d::bf16_f32(v); }
  static __device__ __forceinline__ T st(float v) { return s3d::bf16_rn(v); }
};

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int SLOTS = 2;     // units (1 m-tile x NTW n-tiles) per warp per round
constexpr int NTW = 8;       // n-tiles (8 channels each) per unit
constexpr int MAX_SMEM = 232448;  // bytes of shared memory one block may use

__device__ __forceinline__ float relu20(float v) {
  return fminf(fmaxf(v, 0.f), 20.f);
}

__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int roundk(int n, int k) { return (n + k - 1) / k * k; }
// Smallest plane stride >= n that is 8 (mod 16): 8 or 24 (mod 32).
__host__ __device__ inline int plane(int n) { return (n + 7) / 16 * 16 + 8; }
// Rounds of a stage: P positions (16 per m-tile) x NPt n-tiles, in units of
// one m-tile x NTW n-tiles, SLOTS units per warp per round.
__host__ __device__ inline int rounds(int P, int NPt) {
  return ((P + 15) / 16 * ((NPt + NTW - 1) / NTW) + SLOTS * NWARPS - 1) /
         (SLOTS * NWARPS);
}

struct Geom {
  int cin, w, cout, fin, tin, F, T, stride, tf, tt, has_sc;
  int ew, ext, mw, mid, outp;  // s1 grid (tf+4) x ew, u grid (tf+2) x mw
  int se, sm, so;              // plane strides of s1 (and staged x), u, y1/y2
  int kp9, kp2;                // K of the 3x3 convs and the project, padded
  int bq;                      // float4 per staged-B buffer (two buffers)
  int kx;                      // k-steps (KS channels each) of x per staged chunk
};

template <class E>
int smem_bytes(const Geom& g);

template <class E>
Geom make_geom(int cin, int w, int cout, int fin, int tin, int stride, int tf,
               int tt) {
  Geom g;
  g.cin = cin; g.w = w; g.cout = cout; g.fin = fin; g.tin = tin;
  g.stride = stride; g.tf = tf; g.tt = tt;
  g.F = (fin + stride - 1) / stride;
  g.T = (tin + stride - 1) / stride;
  g.has_sc = 0;
  g.ew = tt + 4; g.ext = (tf + 4) * g.ew;
  g.mw = tt + 2; g.mid = (tf + 2) * g.mw;
  g.outp = tf * tt;
  g.se = plane(g.ext); g.sm = plane(g.mid); g.so = plane(g.outp);
  g.kp9 = roundk(9 * w, E::KS); g.kp2 = roundk(2 * w, E::KS);
  // the deepest x chunk, then the larger B buffer (16 or 8 KB), that fit
  for (g.kx = 4; g.kx > 1; g.kx /= 2) {
    g.bq = 1024;
    if (smem_bytes<E>(g) <= MAX_SMEM) return g;
    g.bq = 512;
    if (smem_bytes<E>(g) <= MAX_SMEM) return g;
  }
  g.bq = smem_bytes<E>(g) <= MAX_SMEM ? 1024 : 512;
  return g;
}

// Staged B (2 x bq float4), s1 [w][se], u [w][sm], staged x (2 x [KS kx][se])
// as elements (the bf16 regions' sizes are even, so the fp32 ones after them
// stay aligned), the biases (b1, bc1, bc2, b3 with Cout <= 256), then the int
// tables: conv1, conv2 (kp9 each), project (kp2), x positions.
template <class E>
int smem_bytes(const Geom& g) {
  return 16 * 2 * g.bq +
         (int)sizeof(typename E::T) * (g.w * (g.se + g.sm) + 2 * E::KS * g.kx * g.se) +
         4 * (4 * g.w + 256 + 2 * g.kp9 + g.kp2 + g.ext);
}

// The expand runs as one stage over the +-2 grid, both halves of h at once,
// when that is one round; else s1 over +-2 and s2 over +-1.
__host__ __device__ inline bool merged_expand(const Geom& g) {
  return rounds(g.ext, round8(2 * g.w) / 8) == 1;
}

// The most n-tiles one round of a stage stages (as make_round counts them).
int max_ntr(int P, int NPt) {
  const int Mt = (P + 15) / 16, U = Mt * ((NPt + NTW - 1) / NTW);
  int most = 0;
  for (int first = 0; first < U; first += SLOTS * NWARPS) {
    const int last = min(U, first + SLOTS * NWARPS) - 1;
    most = max(most, min(NPt, (last / Mt + 1) * NTW) - (first / Mt) * NTW);
  }
  return most;
}

// The kernel's limits: conv1 and conv2 finish in one round (their outputs
// overwrite their inputs' planes), one k-step of a round's B fits a buffer,
// and one thread stages x at each position of the +-2 grid.
template <class E>
bool supported(const Geom& g) {
  const int npw = round8(g.w) / 8, npo = round8(g.cout) / 8;
  return g.w <= 8 * NTW && g.cout <= 256 && g.ext <= THREADS &&
         smem_bytes<E>(g) <= MAX_SMEM &&
         rounds(g.mid, npw) == 1 && rounds(g.outp, npw) == 1 &&
         E::QK * max_ntr(g.outp, npo) <= g.bq &&
         E::QK * max_ntr(g.ext, round8(2 * g.w) / 8) <= g.bq;
}

// Output tiles (frequency x time) the launch picks from. The last, 8 x 16,
// is taken only where neither of the others fits: at w = 64 with Cout = 256
// (ERes2Net large's layer2) 16 x 16 needs 239,680 B of shared memory and
// 8 x 32 254,144 B, 8 x 16 214,976 B. The work model below would also pick
// it at V2's layer2 for short inputs (T <= ~150), where a round of the 3x3
// and project stages holds 8 m-tiles against 16 at 16 x 16 (fewer warps
// busy), which the model does not count; V2 keeps its tiles.
constexpr int TILES[][2] = {{16, 16}, {8, 32}, {8, 16}};
constexpr int N_MAIN_TILES = 2;

// The geometry of the tile whose blocks do the least work (the expand over
// the halos of s1 and s2, or both halves over s1's where one round holds
// them, the 3x3 convs over theirs, the 1x1s over the tile; ragged edges
// included) among the main tiles the kernel takes, else the first fallback
// tile it takes; tf = 0 when it takes none.
template <class E>
Geom pick_geom(int cin, int w, int cout, int fin, int tin, int stride, int has_sc) {
  Geom best{};
  long long best_work = -1;
  for (int i = 0; i < (int)(sizeof(TILES) / sizeof(TILES[0])); ++i) {
    if (i == N_MAIN_TILES && best_work >= 0) break;
    Geom g = make_geom<E>(cin, w, cout, fin, tin, stride, TILES[i][0], TILES[i][1]);
    g.has_sc = has_sc;
    if (!supported<E>(g)) continue;
    const long long expand = merged_expand(g) ? 2LL * g.ext : g.ext + g.mid;
    const long long work =
        (long long)((g.F + g.tf - 1) / g.tf) * ((g.T + g.tt - 1) / g.tt) *
        ((long long)cin * w * expand + 9LL * w * w * (g.mid + g.outp) +
         (2LL * w + (has_sc ? cin : 0)) * cout * g.outp);
    if (best_work < 0 || work < best_work) {
      best = g;
      best_work = work;
    }
  }
  return best;
}

template <class E>
struct Ctx {
  using T = typename E::T;
  const Geom& g;     // the kernel's __grid_constant__ parameter
  float4* bbuf;      // staged B, two buffers
  T* act;            // s1, then u; the tables' offsets are from here
  T* xbuf;           // staged x, two buffers of [KS kx][se]
  int* posx;         // x offset of each position of the stage's grid, or -1
  const T* xb;       // x of this block's batch row
  int f0, t0;
};

// A warp's share of round r of a stage over n-tiles [nb, nb + NPt): units
// u = ng * Mt + m (n-group major), the round taking units [r * 32, r * 32 +
// 32), slot s of warp w unit r * 32 + s * 16 + w. ntlo/ntr: the n-tiles the
// round touches (staged B); nt0 and ntlo count from n-tile 0 of the weight.
struct Round {
  int nsl, m[SLOTS], nt0[SLOTS], nnt[SLOTS], ntlo, ntr;
};

__device__ __forceinline__ Round make_round(int r, int Mt, int nb, int NPt) {
  const int warp = threadIdx.x >> 5, U = Mt * ((NPt + NTW - 1) / NTW);
  Round rd;
  rd.nsl = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int u = r * SLOTS * NWARPS + s * NWARPS + warp;
    rd.m[s] = u < U ? u % Mt : 0;
    rd.nt0[s] = u < U ? (u / Mt) * NTW : 0;
    rd.nnt[s] = u < U ? min(NTW, NPt - rd.nt0[s]) : 0;
    rd.nt0[s] += nb;
    if (u < U) rd.nsl = s + 1;
  }
  const int first = r * SLOTS * NWARPS;
  const int last = min(U, first + SLOTS * NWARPS) - 1;
  rd.ntlo = (first / Mt) * NTW;
  rd.ntr = min(NPt, (last / Mt + 1) * NTW) - rd.ntlo;
  rd.ntlo += nb;
  return rd;
}

using Acc = float[SLOTS][NTW][4];

// acc[s] += A[rows ro[s]] @ B[:, the slot's n-tiles] over nks k-steps, in
// 3xTF32 (F32) or BF16. B (packed [nks][bnt][QK] float4) and, when XA, KS kx
// channels of x at the stage's P grid positions (posx) are staged chunk by
// chunk into shared memory, two buffers shared by every warp: B with
// cp.async, which lands while chunk c is multiplied, x by coalesced loads,
// thread p taking position p, eight channels in flight at a time. A is x
// (XA: element (row p, k) at xbuf[(k - k0) * se + p] for the chunk's first
// k0) or the block's activations (act[ro + tab[k]]).
template <class E, bool XA>
__device__ __forceinline__ void kloop(Acc& acc, const Ctx<E>& c, const Round& rd,
                                      const int (&ro)[SLOTS][2],
                                      const int* tab,
                                      const float4* __restrict__ bp, int bnt,
                                      int nks, int P) {
  using T = typename E::T;
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int per = rd.ntr * E::QK;  // float4 of B per k-step
  const int kc = max(1, min(XA ? c.g.kx : 8, c.g.bq / per));
  const int nch = (nks + kc - 1) / kc;
  const int in_plane = c.g.fin * c.g.tin;
  auto issue = [&](int ch) {
    const int k0 = ch * kc, n = min(kc, nks - k0);
    float4* dst = c.bbuf + (ch & 1) * c.g.bq;
    for (int i = tid; i < n * per; i += THREADS) {
      const int ks = i / per;
      cp_async16(dst + i, bp + ((size_t)(k0 + ks) * bnt + rd.ntlo) * E::QK + (i - ks * per));
    }
    if (XA) {  // this thread's position, 8 channels per batch of loads
      T* xd = c.xbuf + (ch & 1) * E::KS * c.g.kx * c.g.se;
      const int o = tid < P ? c.posx[tid] : -1;
      for (int cc0 = 0; cc0 < E::KS * n; cc0 += 8) {
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int chn = k0 * E::KS + cc0 + j;
          v[j] = o >= 0 && chn < c.g.cin ? __ldg(c.xb + (size_t)chn * in_plane + o) : T(0);
        }
        if (tid < P) {
#pragma unroll
          for (int j = 0; j < 8; ++j) xd[(cc0 + j) * c.g.se + tid] = v[j];
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) issue(ch + 1);
    else cp_async_commit();  // an empty group keeps wait_group 1 exact
    cp_async_wait1();
    __syncthreads();
    const float4* bb = c.bbuf + (ch & 1) * c.g.bq;
    const T* a = XA ? c.xbuf + (ch & 1) * E::KS * c.g.kx * c.g.se : c.act;
    const int n = min(kc, nks - ch * kc);
    for (int ksl = 0; ksl < n; ++ksl) {
      if constexpr (E::IS_BF16) {
        // the lane's k: 2t, 2t + 1, 2t + 8, 2t + 9 of the k-step
        int o[4];
        if (XA) {
          o[0] = (ksl * 16 + 2 * t) * c.g.se;
          o[1] = o[0] + c.g.se;
          o[2] = o[0] + 8 * c.g.se;
          o[3] = o[2] + c.g.se;
        } else {
          const int k = (ch * kc + ksl) * 16 + 2 * t;
          o[0] = tab[k];
          o[1] = tab[k + 1];
          o[2] = tab[k + 8];
          o[3] = tab[k + 9];
        }
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s < rd.nsl) {
            const T* r0 = a + ro[s][0];
            const T* r1 = a + ro[s][1];
            const uint32_t af[4] = {s3d::bf16x2(r0[o[0]], r0[o[1]]),
                                    s3d::bf16x2(r1[o[0]], r1[o[1]]),
                                    s3d::bf16x2(r0[o[2]], r0[o[3]]),
                                    s3d::bf16x2(r1[o[2]], r1[o[3]])};
            const uint2* bk = reinterpret_cast<const uint2*>(bb) +
                              (ksl * rd.ntr + rd.nt0[s] - rd.ntlo) * 32 + lane;
            // one pass, accumulated by the tensor cores in fp32
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              if (nt < rd.nnt[s]) {
                const uint2 q = bk[nt * 32];
                s3d::mma_bf16(acc[s][nt], af, q.x, q.y);
              }
            }
          }
        }
      } else {
        int lo, hi;
        if (XA) {
          lo = (ksl * 8 + t) * c.g.se;
          hi = lo + 4 * c.g.se;
        } else {
          const int k = (ch * kc + ksl) * 8 + t;
          lo = tab[k];
          hi = tab[k + 4];
        }
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s < rd.nsl) {
            uint32_t ab[4], as[4];
            split(a[ro[s][0] + lo], ab[0], as[0]);
            split(a[ro[s][1] + lo], ab[1], as[1]);
            split(a[ro[s][0] + hi], ab[2], as[2]);
            split(a[ro[s][1] + hi], ab[3], as[3]);
            const float4* bk = bb + (ksl * rd.ntr + rd.nt0[s] - rd.ntlo) * 32 + lane;
            // two n-tiles at a time, term by term: consecutive mma are
            // independent, and the two small cross terms go first. Each
            // k-step's sum starts from zero and is added to the running sum
            // in fp32 (round to nearest): the tensor cores' own accumulation
            // truncates, and over K = 9w that error outgrew the split's by
            // several times
#pragma unroll
            for (int nt = 0; nt < NTW; nt += 2) {
              if (nt < rd.nnt[s]) {
                const bool two = nt + 1 < rd.nnt[s];
                const float4 q0 = bk[nt * 32];
                const float4 q1 = two ? bk[(nt + 1) * 32] : q0;
                float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
                mma(d0, as, __float_as_uint(q0.x), __float_as_uint(q0.y));
                if (two) mma(d1, as, __float_as_uint(q1.x), __float_as_uint(q1.y));
                mma(d0, ab, __float_as_uint(q0.z), __float_as_uint(q0.w));
                if (two) mma(d1, ab, __float_as_uint(q1.z), __float_as_uint(q1.w));
                mma(d0, ab, __float_as_uint(q0.x), __float_as_uint(q0.y));
                if (two) mma(d1, ab, __float_as_uint(q1.x), __float_as_uint(q1.y));
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  acc[s][nt][i] += d0[i];
                  if (two) acc[s][nt + 1][i] += d1[i];
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// What an epilogue needs of one output position, computed once per row.
struct Pos {
  int p, a, b;
  bool in;
};

// One stage: P positions x n-tiles [nb, nb + NPt) of weights with bnt
// n-tiles, round by round; the accumulators start at bias[n] (shared
// memory, readable up to the last padded n). The main K phase reads A
// through row(p) (+ tab, or staged x when XA); bsc, when set, adds a second
// phase over staged x (the shortcut) at the same positions. epi(pos(p), n,
// v, ok) stores each element, ok false for padding rows and slots, once the
// round's K loops are done (after a barrier, so it may overwrite what the
// loops read); it stores by predicate, without branches.
template <class E, bool XA, class Row, class PosFn, class Epi>
__device__ __forceinline__ void run_stage(const Ctx<E>& c, int P, int nb, int NPt,
                                          int bnt, const float* bias,
                                          const int* tab, const float4* bp,
                                          int nks, Row row,
                                          const float4* bsc, PosFn pos,
                                          Epi epi) {
  const int Mt = (P + 15) / 16, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int nr = rounds(P, NPt);
  for (int r = 0; r < nr; ++r) {
    const Round rd = make_round(r, Mt, nb, NPt);
    int ro[SLOTS][2];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) ro[s][h] = row(min(rd.m[s] * 16 + g + 8 * h, P - 1));
    Acc acc;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[s][nt][i] = bias[(rd.nt0[s] + nt) * 8 + 2 * t + (i & 1)];
    kloop<E, XA>(acc, c, rd, ro, tab, bp, bnt, nks, P);
    if (bsc != nullptr) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) ro[s][h] = min(rd.m[s] * 16 + g + 8 * h, P - 1);
      kloop<E, true>(acc, c, rd, ro, nullptr, bsc, bnt, roundk(c.g.cin, E::KS) / E::KS, P);
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = rd.m[s] * 16 + g + 8 * h;
        const bool row_ok = s < rd.nsl && p < P;
        const Pos ps = pos(min(p, P - 1));
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            epi(ps, (rd.nt0[s] + nt) * 8 + 2 * t + i, acc[s][nt][2 * h + i],
                row_ok && nt < rd.nnt[s]);
      }
  }
}

// posx[p] for the P positions of a grid gw wide whose origin is (f0 + fo,
// t0 + to): x's offset at that output position, -1 outside the image.
template <class E>
__device__ __forceinline__ void set_posx(const Ctx<E>& c, int P, int gw, int fo, int to) {
  for (int p = threadIdx.x; p < P; p += THREADS) {
    const int f = c.f0 + fo + p / gw, t = c.t0 + to + p % gw;
    c.posx[p] = f >= 0 && f < c.g.F && t >= 0 && t < c.g.T
                    ? (f * c.g.stride) * c.g.tin + t * c.g.stride : -1;
  }
}

template <class E>
__global__ void __launch_bounds__(THREADS, 1)
res2_block_kernel(const typename E::T* __restrict__ x, const float4* __restrict__ w1,
                  const float* __restrict__ b1,
                  const float4* __restrict__ wc1, const float* __restrict__ bc1,
                  const float4* __restrict__ wc2, const float* __restrict__ bc2,
                  const float4* __restrict__ w3, const float* __restrict__ b3,
                  const float4* __restrict__ wsc, typename E::T* __restrict__ out,
                  const __grid_constant__ Geom g) {
  using T = typename E::T;
  extern __shared__ float4 smem4[];
  const int W = g.w;
  T* act = reinterpret_cast<T*>(smem4 + 2 * g.bq);
  T* s1 = act;                      // [w][se]: h[:w] over the +-2 halo; then y1 [w][so]
  T* u = s1 + W * g.se;             // [w][sm]: h[w:] (+ y1) over +-1; then y2 [w][so]
  T* xbuf = u + W * g.sm;           // 2 x [KS kx][se]
  // biases: b1 [2w], bc1 [w], bc2 [w], b3 [cout]
  float* sb1 = reinterpret_cast<float*>(xbuf + 2 * E::KS * g.kx * g.se);
  float* sbc1 = sb1 + 2 * W;
  float* sbc2 = sbc1 + W;
  float* sb3 = sbc2 + W;
  int* tab1 = reinterpret_cast<int*>(sb3 + 256);  // conv1: k -> offset
  int* tab2 = tab1 + g.kp9;                       // conv2
  int* tab3 = tab2 + g.kp9;                       // project, [y1; y2]
  const int n_tt = (g.T + g.tt - 1) / g.tt;
  const int f0 = (blockIdx.x / n_tt) * g.tf, t0 = (blockIdx.x % n_tt) * g.tt;
  const Ctx<E> c{g, smem4, act, xbuf, tab3 + g.kp2,
                 x + (size_t)blockIdx.y * g.cin * g.fin * g.tin, f0, t0};
  for (int i = threadIdx.x; i < 2 * W; i += THREADS) sb1[i] = b1[i];
  for (int i = threadIdx.x; i < W; i += THREADS) {
    sbc1[i] = bc1[i];
    sbc2[i] = bc2[i];
  }
  for (int i = threadIdx.x; i < 256; i += THREADS) sb3[i] = i < g.cout ? b3[i] : 0.f;

  for (int k = threadIdx.x; k < g.kp9; k += THREADS) {
    const int kk = min(k, 9 * W - 1), tap = kk / W, ch = kk % W;
    const int df = tap / 3, dt = tap % 3;
    tab1[k] = ch * g.se + df * g.ew + dt;
    tab2[k] = W * g.se + ch * g.sm + df * g.mw + dt;
  }
  for (int k = threadIdx.x; k < g.kp2; k += THREADS) {
    const int kk = min(k, 2 * W - 1);
    tab3[k] = kk < W ? kk * g.so : W * g.se + (kk - W) * g.so;
  }
  const int npw = round8(W) / 8, npo = round8(g.cout) / 8;
  const int cks = roundk(g.cin, E::KS) / E::KS;
  const int nph = round8(2 * W) / 8;  // n-tiles of W1 (both halves of h)
  auto inside = [&](int f, int t) { return f >= 0 && f < g.F && t >= 0 && t < g.T; };
  auto id = [](int p) { return p; };

  // ---- stage 1: h = relu20(W1 @ x + b1): s1 over +-2, s2 over +-1, 0 outside
  set_posx(c, g.ext, g.ew, -2, -2);
  __syncthreads();
  if (merged_expand(g)) {
    // both halves over +-2 in one pass over x; s2 kept where the +-1 grid is
    run_stage<E, true>(c, g.ext, 0, nph, nph, sb1, nullptr, w1, cks, id, nullptr,
                    [&](int p) {  // a: the position's index in the +-1 grid, or -1
                      const int ef = p / g.ew, et = p % g.ew;
                      const bool mid = ef >= 1 && ef <= g.tf + 2 && et >= 1 && et <= g.tt + 2;
                      return Pos{p, mid ? (ef - 1) * g.mw + et - 1 : -1, 0,
                                 inside(f0 - 2 + ef, t0 - 2 + et)};
                    },
                    [&](const Pos& q, int n, float v, bool ok) {
                      const T h = E::st(q.in ? relu20(v) : 0.f);
                      if (ok && n < W) s1[n * g.se + q.p] = h;
                      if (ok && n >= W && n < 2 * W && q.a >= 0) u[(n - W) * g.sm + q.a] = h;
                    });
  } else {
    run_stage<E, true>(c, g.ext, 0, npw, nph, sb1, nullptr, w1, cks, id, nullptr,
                    [&](int p) {
                      return Pos{p, 0, 0, inside(f0 - 2 + p / g.ew, t0 - 2 + p % g.ew)};
                    },
                    [&](const Pos& q, int n, float v, bool ok) {
                      if (ok && n < W) s1[n * g.se + q.p] = E::st(q.in ? relu20(v) : 0.f);
                    });
    set_posx(c, g.mid, g.mw, -1, -1);
    __syncthreads();
    // n-tiles from the one holding channel w (its first channels are s1's)
    run_stage<E, true>(c, g.mid, W / 8, nph - W / 8, nph, sb1, nullptr, w1, cks, id, nullptr,
                    [&](int p) {
                      return Pos{p, 0, 0, inside(f0 - 1 + p / g.mw, t0 - 1 + p % g.mw)};
                    },
                    [&](const Pos& q, int n, float v, bool ok) {
                      if (ok && n >= W && n < 2 * W)
                        u[(n - W) * g.sm + q.p] = E::st(q.in ? relu20(v) : 0.f);
                    });
  }
  __syncthreads();

  // ---- stage 2: y1 = relu20(conv3x3(s1) + bc1) over +-1; u = s2 + y1 (in
  // bf16: y1 rounded, then the sum rounded); y1 over the tile into s1's
  // planes (s1 is dead once the round's K loop has ended)
  run_stage<E, false>(c, g.mid, 0, npw, npw, sbc1, tab1, wc1, g.kp9 / E::KS,
                   [&](int p) { return (p / g.mw) * g.ew + p % g.mw; }, nullptr,
                   [&](int p) {  // a: y1's index over the tile, or -1 in the halo
                     const int mf = p / g.mw, mt = p % g.mw;
                     const bool ctr = mf >= 1 && mf <= g.tf && mt >= 1 && mt <= g.tt;
                     return Pos{p, ctr ? (mf - 1) * g.tt + mt - 1 : -1, 0,
                                inside(f0 - 1 + mf, t0 - 1 + mt)};
                   },
                   [&](const Pos& q, int n, float v, bool ok) {
                     const T y = E::st(q.in ? relu20(v) : 0.f);
                     if (ok && n < W) u[n * g.sm + q.p] = E::st(E::ld(u[n * g.sm + q.p]) + E::ld(y));
                     if (ok && n < W && q.a >= 0) s1[n * g.so + q.a] = y;
                   });
  __syncthreads();

  // ---- stage 3: y2 = relu20(conv3x3(u) + bc2) over the tile, into u's planes
  run_stage<E, false>(c, g.outp, 0, npw, npw, sbc2, tab2, wc2, g.kp9 / E::KS,
                   [&](int p) { return (p / g.tt) * g.mw + p % g.tt; }, nullptr,
                   [](int p) { return Pos{p, 0, 0, true}; },
                   [&](const Pos& q, int n, float v, bool ok) {
                     if (ok && n < W) u[n * g.so + q.p] = E::st(relu20(v));
                   });
  set_posx(c, g.outp, g.tt, 0, 0);
  __syncthreads();

  // ---- stage 4: out = relu20(W3 @ [y1; y2] + b3 + shortcut) ----
  const size_t out_plane = (size_t)g.F * g.T, in_plane = (size_t)g.fin * g.tin;
  T* ob = out + (size_t)blockIdx.y * g.cout * out_plane;
  run_stage<E, false>(c, g.outp, 0, npo, npo, sb3, tab3, w3, g.kp2 / E::KS, id,
                   g.has_sc ? wsc : nullptr,
                   [&](int p) {  // a: out's offset in a plane, b: x's
                     const int f = f0 + p / g.tt, t = t0 + p % g.tt;
                     return Pos{p, f * g.T + t, (f * g.stride) * g.tin + t * g.stride,
                                f < g.F && t < g.T};
                   },
                   [&](const Pos& q, int n, float v, bool ok) {
                     ok = ok && n < g.cout && q.in;
                     const float r = g.has_sc || !ok ? 0.f : E::ld(__ldg(c.xb + n * in_plane + q.b));
                     if (ok) ob[n * out_plane + q.a] = E::st(relu20(v + r));
                   });
}

template <class E>
int launch(const void* x, const void* w1, const void* b1, const void* wc1,
           const void* bc1, const void* wc2, const void* bc2, const void* w3,
           const void* b3, const void* wsc, void* out, int batch, int cin,
           int w, int cout, int fin, int tin, int stride, void* stream) {
  using T = typename E::T;
  const Geom g = pick_geom<E>(cin, w, cout, fin, tin, stride, wsc != nullptr);
  if (g.tf == 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes<E>(g);
  cudaError_t err = cudaFuncSetAttribute(
      res2_block_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((g.F + g.tf - 1) / g.tf) * ((g.T + g.tt - 1) / g.tt);
  dim3 grid(n_tiles, batch);
  res2_block_kernel<E><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float4*>(w1),
      static_cast<const float*>(b1),
      static_cast<const float4*>(wc1), static_cast<const float*>(bc1),
      static_cast<const float4*>(wc2), static_cast<const float*>(bc2),
      static_cast<const float4*>(w3), static_cast<const float*>(b3),
      static_cast<const float4*>(wsc), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* s3d_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [batch, cin, fin, tin] -> out [batch, cout, F, T], F = ceil(fin / stride),
// T = ceil(tin / stride), one block per output tile (pick_geom) and batch row.
// Weights packed by the wrapper's fold (3xTF32 B fragments, [K/8][N/8][32]
// float4, K and N padded to multiples of 8): w1 the expand [cin][2w], wc1/wc2
// [9w][w] (k = (df*3 + dt)*w + c), w3 [2w][cout], wsc [cin][cout] or null when
// the shortcut is the identity (stride 1, cin == cout). b1 [2w], bc1/bc2 [w],
// b3 [cout] (with the shortcut's folded bias). All fp32, contiguous, on the
// device of `stream`. cudaErrorInvalidValue when no tile takes the shape.
int s3d_res2_block_f32(const void* x, const void* w1, const void* b1, const void* wc1, const void* bc1,
                       const void* wc2, const void* bc2, const void* w3,
                       const void* b3, const void* wsc, void* out, int batch,
                       int cin, int w, int cout, int fin, int tin, int stride,
                       void* stream) {
  return launch<F32>(x, w1, b1, wc1, bc1, wc2, bc2, w3, b3, wsc, out, batch,
                     cin, w, cout, fin, tin, stride, stream);
}

// The same block with bf16 x and out and bf16 weights packed as m16n8k16 B
// fragments ([K/16][N/8][32] x 4 bf16, K padded to a multiple of 16, N of
// 8); the biases stay fp32.
int s3d_res2_block_bf16(const void* x, const void* w1, const void* b1, const void* wc1, const void* bc1,
                        const void* wc2, const void* bc2, const void* w3,
                        const void* b3, const void* wsc, void* out, int batch,
                        int cin, int w, int cout, int fin, int tin, int stride,
                        void* stream) {
  return launch<BF16>(x, w1, b1, wc1, bc1, wc2, bc2, w3, b3, wsc, out, batch,
                      cin, w, cout, fin, tin, stride, stream);
}

}  // extern "C"
