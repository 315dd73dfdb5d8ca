// One BN-folded, inference-only ERes2NetV2 Res2 block (scale 2, no AFF) for
// Hopper (sm_90a), fp32 on the CUDA cores, NCHW activations.
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
// inside the kernel (the reference's 1x1 stride-2 convs do the same).
//
// What bounds it on the H100: the contractions. On the 17.8M model's path
// (B = 64, 1.5 s) a layer1 block does ~39 GFLOP against ~0.8 GB of
// activations in and out, above the fp32 ridge, so it is bound by fp32 FMA
// throughput (fp32 is the path's dtype; a bf16 tensor-core variant is later
// work).
//
// Design: the TPU kernel kept all of F in VMEM ([F, Tt+4, Cin]); at F = 80,
// Cin = 128 that is ~1.5 MB, far above the 227 KB of shared memory a block
// may use. So a block owns a TF x TT tile of output positions for one batch
// row and all channels, and keeps in shared memory:
//   - h over the tile with a +-2 halo in both axes ((TF+4) x (TT+4)), which
//     the two chained 3x3 convs need, zeroed outside [0,F) x [0,T) — that
//     recreates the convs' zero padding in both axes (the TPU kernel got F's
//     from explicit zero rows and T's from a time mask);
//   - y1 over the tile with a +-1 halo.
// The halo of h is recomputed by neighbouring blocks instead of exchanged.
// y1 is added into the second half of h in place (u = s2 + y1), and y2 is
// written over the first half once y1 has consumed it, so h and y1 are the
// block's only buffers. x is read from device memory (L2) at the halo
// positions for the expand and again at the centre for the shortcut.
// Each stage is the same register-tiled product: a warp takes RO output
// channels x 32*RP positions, lanes on consecutive positions (shared-memory
// reads conflict-free, weight reads warp-uniform), the 3x3 convs as nine
// shifted taps over the shared tile (implicit im2col, nothing materialised).
// Weights arrive K-major ([K][O]) from the wrapper's fold.
//
// Plain C interface (bound with ctypes); every entry point returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RO = 8;   // output channels per thread
constexpr int RP = 4;   // positions per lane (strided by 32)

__device__ __forceinline__ float relu20(float v) {
  return fminf(fmaxf(v, 0.f), 20.f);
}

// acc[i][j] += sum_{tap, c} Wt[(tap*C + c)*O + o0 + i] * src[c*plane + off(tap) + pb[j]]
// for taps on an nf x nt grid with off = df*ldw + dt. Rows o >= O read the
// last row (clamped) and are dropped by the caller.
__device__ __forceinline__ void mm_acc(float (&acc)[RO][RP], int o0, int O,
                                       const int (&pb)[RP],
                                       const float* src, long plane, int C,
                                       int nf, int nt, int ldw,
                                       const float* __restrict__ Wt) {
  int oi[RO];
#pragma unroll
  for (int i = 0; i < RO; ++i) oi[i] = min(o0 + i, O - 1);
  for (int df = 0; df < nf; ++df)
    for (int dt = 0; dt < nt; ++dt) {
      const int off = df * ldw + dt;
      const float* wk = Wt + (size_t)((df * nt + dt) * C) * O;
      const float* s = src + off;
#pragma unroll 2
      for (int c = 0; c < C; ++c) {
        float wv[RO], iv[RP];
#pragma unroll
        for (int i = 0; i < RO; ++i) wv[i] = __ldg(wk + oi[i]);
#pragma unroll
        for (int j = 0; j < RP; ++j) iv[j] = s[pb[j]];
#pragma unroll
        for (int i = 0; i < RO; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) acc[i][j] = fmaf(wv[i], iv[j], acc[i][j]);
        wk += O;
        s += plane;
      }
    }
}

__device__ __forceinline__ void zero(float (&acc)[RO][RP]) {
#pragma unroll
  for (int i = 0; i < RO; ++i)
#pragma unroll
    for (int j = 0; j < RP; ++j) acc[i][j] = 0.f;
}

struct Geom {
  int cin, w, cout, fin, tin, F, T, stride, tf, tt, has_sc;
};

__global__ void __launch_bounds__(THREADS)
res2_block_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ wc1,
                  const float* __restrict__ bc1, const float* __restrict__ wc2,
                  const float* __restrict__ bc2, const float* __restrict__ w3,
                  const float* __restrict__ b3, const float* __restrict__ wsc,
                  float* __restrict__ out, Geom g) {
  extern __shared__ float smem[];
  const int W = g.w, W2 = 2 * g.w;
  const int EF = g.tf + 4, ET = g.tt + 4, EXT = EF * ET;  // h tile (+-2)
  const int MF = g.tf + 2, MT = g.tt + 2, MID = MF * MT;  // y1 tile (+-1)
  const int OUTP = g.tf * g.tt;
  float* h = smem;            // [2w][EXT]; later [y2 | u]
  float* y1 = h + W2 * EXT;   // [w][MID]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = THREADS / 32;
  const int n_tt = (g.T + g.tt - 1) / g.tt;
  const int f0 = (blockIdx.x / n_tt) * g.tf, t0 = (blockIdx.x % n_tt) * g.tt;
  const int b = blockIdx.y;
  const long in_plane = (long)g.fin * g.tin;
  const float* xb = x + (size_t)b * g.cin * in_plane;

  // ---- stage 1: h = relu20(W1 @ x + b1) over the +-2 halo, 0 outside ----
  {
    const int n_pg = (EXT + 32 * RP - 1) / (32 * RP);
    const int n_og = (W2 + RO - 1) / RO;
    for (int u = warp; u < n_pg * n_og; u += nwarps) {
      const int o0 = (u / n_pg) * RO, pbase = (u % n_pg) * 32 * RP + lane;
      int pb[RP];
      bool ok[RP];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int p = pbase + 32 * j;
        const int f = f0 - 2 + p / ET, t = t0 - 2 + p % ET;
        ok[j] = p < EXT && f >= 0 && f < g.F && t >= 0 && t < g.T;
        pb[j] = ok[j] ? (f * g.stride) * g.tin + t * g.stride : 0;
      }
      float acc[RO][RP];
      zero(acc);
      mm_acc(acc, o0, W2, pb, xb, in_plane, g.cin, 1, 1, 0, w1);
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int o = o0 + i, p = pbase + 32 * j;
          if (o < W2 && p < EXT)
            h[o * EXT + p] = ok[j] ? relu20(acc[i][j] + b1[o]) : 0.f;
        }
    }
  }
  __syncthreads();

  // ---- stage 2: y1 = relu20(conv3x3(s1) + bc1) over the +-1 halo; u = s2 + y1
  {
    const int n_pg = (MID + 32 * RP - 1) / (32 * RP);
    const int n_og = (W + RO - 1) / RO;
    for (int u = warp; u < n_pg * n_og; u += nwarps) {
      const int o0 = (u / n_pg) * RO, pbase = (u % n_pg) * 32 * RP + lane;
      int pb[RP];
      bool ok[RP];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int p = min(pbase + 32 * j, MID - 1);
        const int mf = p / MT, mt = p % MT;
        const int f = f0 - 1 + mf, t = t0 - 1 + mt;
        ok[j] = f >= 0 && f < g.F && t >= 0 && t < g.T;
        pb[j] = mf * ET + mt;  // tap (0,0) of the window centred at ext (mf+1, mt+1)
      }
      float acc[RO][RP];
      zero(acc);
      mm_acc(acc, o0, W, pb, h, EXT, W, 3, 3, ET, wc1);
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int o = o0 + i, p = pbase + 32 * j;
          if (o < W && p < MID) {
            const float v = ok[j] ? relu20(acc[i][j] + bc1[o]) : 0.f;
            y1[o * MID + p] = v;
            h[(W + o) * EXT + (p / MT + 1) * ET + p % MT + 1] += v;
          }
        }
    }
  }
  __syncthreads();

  // ---- stage 3: y2 = relu20(conv3x3(u) + bc2) on the tile, into h[:w] ----
  {
    const int n_pg = (OUTP + 32 * RP - 1) / (32 * RP);
    const int n_og = (W + RO - 1) / RO;
    for (int u = warp; u < n_pg * n_og; u += nwarps) {
      const int o0 = (u / n_pg) * RO, pbase = (u % n_pg) * 32 * RP + lane;
      int pb[RP];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int p = min(pbase + 32 * j, OUTP - 1);
        pb[j] = (p / g.tt + 1) * ET + p % g.tt + 1;
      }
      float acc[RO][RP];
      zero(acc);
      mm_acc(acc, o0, W, pb, h + W * EXT, EXT, W, 3, 3, ET, wc2);
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int o = o0 + i, p = pbase + 32 * j;
          if (o < W && p < OUTP) h[o * EXT + p] = relu20(acc[i][j] + bc2[o]);
        }
    }
  }
  __syncthreads();

  // ---- stage 4: out = relu20(W3 @ [y1; y2] + b3 + shortcut) ----
  {
    const int n_pg = (OUTP + 32 * RP - 1) / (32 * RP);
    const int n_og = (g.cout + RO - 1) / RO;
    const long out_plane = (long)g.F * g.T;
    float* ob = out + (size_t)b * g.cout * out_plane;
    for (int u = warp; u < n_pg * n_og; u += nwarps) {
      const int o0 = (u / n_pg) * RO, pbase = (u % n_pg) * 32 * RP + lane;
      int pm[RP], po[RP], px[RP], f[RP], t[RP];
      bool ok[RP];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int p = pbase + 32 * j;
        const int pc = min(p, OUTP - 1);
        const int pf = pc / g.tt, pt = pc % g.tt;
        f[j] = f0 + pf;
        t[j] = t0 + pt;
        ok[j] = p < OUTP && f[j] < g.F && t[j] < g.T;
        pm[j] = (pf + 1) * MT + pt + 1;  // y1 centre
        po[j] = pc;                      // y2
        px[j] = ok[j] ? (f[j] * g.stride) * g.tin + t[j] * g.stride : 0;
      }
      float acc[RO][RP];
      zero(acc);
      mm_acc(acc, o0, g.cout, pm, y1, MID, W, 1, 1, 0, w3);
      mm_acc(acc, o0, g.cout, po, h, EXT, W, 1, 1, 0, w3 + (size_t)W * g.cout);
      if (g.has_sc) mm_acc(acc, o0, g.cout, px, xb, in_plane, g.cin, 1, 1, 0, wsc);
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int o = o0 + i;
          if (o < g.cout && ok[j]) {
            float v = acc[i][j] + b3[o];
            if (!g.has_sc) v += xb[o * in_plane + px[j]];
            ob[o * out_plane + (long)f[j] * g.T + t[j]] = relu20(v);
          }
        }
    }
  }
}

int smem_bytes(int w, int tf, int tt) {
  return (int)sizeof(float) * (2 * w * (tf + 4) * (tt + 4) + w * (tf + 2) * (tt + 2));
}

}  // namespace

extern "C" {

const char* s3d_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared-memory bytes one block needs for split width w and a tf x tt tile.
int s3d_res2_smem_bytes(int w, int tf, int tt) { return smem_bytes(w, tf, tt); }

// x [batch, cin, fin, tin] -> out [batch, cout, F, T], F = ceil(fin / stride),
// T = ceil(tin / stride). Weights K-major: w1 [cin][2w], wc1/wc2 [9w][w]
// (k = (df*3 + dt)*w + c), w3 [2w][cout], wsc [cin][cout] or null when the
// shortcut is the identity (stride 1, cin == cout). b3 carries the shortcut's
// folded bias. All fp32, contiguous, on the device of `stream`.
int s3d_res2_block_f32(const void* x, const void* w1, const void* b1,
                       const void* wc1, const void* bc1, const void* wc2,
                       const void* bc2, const void* w3, const void* b3,
                       const void* wsc, void* out, int batch, int cin, int w,
                       int cout, int fin, int tin, int stride, int tf, int tt,
                       void* stream) {
  Geom g;
  g.cin = cin; g.w = w; g.cout = cout; g.fin = fin; g.tin = tin;
  g.stride = stride;
  g.F = (fin + stride - 1) / stride;
  g.T = (tin + stride - 1) / stride;
  g.tf = tf; g.tt = tt;
  g.has_sc = wsc != nullptr;
  const int smem = smem_bytes(w, tf, tt);
  cudaError_t err = cudaFuncSetAttribute(
      res2_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((g.F + tf - 1) / tf) * ((g.T + tt - 1) / tt);
  dim3 grid(n_tiles, batch);
  res2_block_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wc1),
      static_cast<const float*>(bc1), static_cast<const float*>(wc2),
      static_cast<const float*>(bc2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(wsc),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
