// Paged decode attention (one new query token per slot) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_flash_attention` / `_paged_kernel` in
// src/repro/kernels/paged_attention.py (pallas_call at line 113).
//
// What bounds it on the H100: bytes.  A slot reads its kept keys' K and V
// rows once (2 * n_keys * K * D elements) and does 4 * D flops per (query
// head, key): 1 flop per byte at the SLM (G = 1, bf16), 5 at hymba (G = 5),
// far under the ~295 flops/byte where the tensor cores would bind.  The
// byte bound is (2 * n_keys * K * D + 2 * B * H * D) * sizeof(T) over
// 3.35 TB/s.  So the design keeps whole key tiles in flight.  The
// arithmetic still has to hide under the copies: on CUDA-core FMAs the
// conversions, shared-memory reads and shuffles around each product cost
// about as much again as the products, and at hymba's G = 5 that walk's
// instructions, not its bytes, set its time (chip_smoke.py's row A times
// both walks).  So bf16 at D 64 and 128 (the served models) computes
// S = Q K^T and O += P V on mma.sync, about a tenth of the instructions
// per key (the "mma" walk); f32 and the other head sizes take the FMA
// walk ("fma"), which the wrapper can also force.
//
// Design:
//   * grid (S, K * head chunks, B), launched as thread-block clusters of
//     (S, 1, 1), S in {1, 2, 4, 8}: the S blocks of a cluster split one
//     (slot, KV head, query-head chunk)'s key walk.  Each block reads
//     lens[b] and takes a contiguous share, in whole key tiles, of the
//     keys the mask keeps, [max(0, len - window), len): no host read of
//     the lengths, so a CUDA graph can capture the launch.
//   * inside a block each of the 4 warps walks every 4th tile of the
//     share on its own, with no block barrier in the loop: a ring of NSTW
//     stages of TK keys (K and V rows of the KV head) per warp in dynamic
//     shared memory (3 of 16 keys on the mma walk, 2 of 4 KB on the FMA
//     walk), filled by 16-byte cp.async while earlier tiles are consumed.
//     A key's row address is bt[t / ps] (the block table's row is staged
//     in shared memory first), so a tile may span pages.
//   * the mma walk: the block's query heads are the rows of the A operand
//     (rows past GC are zero), a tile's 16 keys are two n-tiles of S and
//     the k-step of P V (P as the A fragment, rounded to bf16 as the
//     prefill kernel does); one max and one rescale per tile and head.
//   * the FMA walk: TPK lanes per key compute the key's scores for the
//     block's query heads; one warp max and at most one rescale per tile;
//     each p is computed once, and P V reads V from the ring with lanes
//     over (16-byte chunk, key subset).
//   * a row's 16-byte chunks are XOR-swizzled by the key, so ldmatrix and
//     both FMA passes read shared memory without bank conflicts.
//   * the warps' partial states (m, l, acc[ng][D], f32, base-2 logits)
//     merge in shared memory into the block's, which each block stores
//     into its slot in rank 0's shared memory (distributed shared memory);
//     after one cluster.sync() rank 0 merges the S partials and writes the
//     output.  One launch, no scratch, no atomics: every sum is taken in a
//     fixed order, so the result does not change from run to run.  An
//     empty share (a short sequence, an idle slot) keeps m = NEG_INF,
//     l = 0 and merges as weight 0; an idle slot (len == 0) writes exact
//     zeros.
//   * the launch allows programmatic dependent launch, so it may start
//     during the previous kernel's tail; griddepcontrol.wait holds every
//     read until that kernel has finished.
// GQA is the index h / G: the G query heads of a KV head share every tile;
// a block serves GC = min(G, 8) of them, so no register holds a head the
// block does not have.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_GC = 8;          // query heads per block at most
constexpr int STAGE_BYTES = 4096;  // one ring stage of the FMA walk: K and V rows

// the walks that take (T, D): "mma" for bf16 at D 64 or 128, "fma" for all
template <typename T, int D>
constexpr bool mma_takes() { return sizeof(T) == 2 && (D == 64 || D == 128); }

template <typename T, int D, bool MMA>
struct Shape {
  static_assert(!MMA || mma_takes<T, D>(), "the mma walk takes bf16 at D 64 or 128");
  static constexpr int ROW = D * (int)sizeof(T);            // bytes of one K or V row
  static constexpr int NCH = ROW / 16;                      // 16-byte chunks per row
  static constexpr int EPC = 16 / (int)sizeof(T);           // elements per chunk
  static constexpr int TK = MMA ? 16                        // keys per tile
                          : STAGE_BYTES / (2 * ROW) < 32 ? STAGE_BYTES / (2 * ROW) : 32;
  static constexpr int TPK = 32 / TK;                       // lanes per key (FMA scores)
  static constexpr int CPT = NCH / TPK;                     // chunks per lane (scores)
  static constexpr int CPL = NCH > 32 ? NCH / 32 : 1;       // chunks per lane (P V)
  static constexpr int SUBW = NCH < 32 ? 32 / NCH : 1;      // key subsets per warp (P V)
  static constexpr int KPL = TK / SUBW;                     // keys per lane and tile (P V)
  static constexpr int STAGE = 2 * TK * ROW;                // K tile, then V tile
  static constexpr int NSTW = MMA ? 3 : 2;                  // ring stages per warp
  // a row's 16-byte chunk c lies at c ^ ((key * SWM) & SWZ): the FMA walk's
  // TPK lanes of a key, and ldmatrix's 8 rows, each read distinct banks
  static constexpr int SWZ = (NCH < 8 ? NCH : 8) - 1;
  static constexpr int SWM = MMA ? 1 : TPK;
  static_assert(CPT >= 1 && KPL >= 1 && TK * TPK == 32, "tile shape");
};

template <typename T, int D, int GC, bool MMA>
struct Smem {
  using S = Shape<T, D, MMA>;
  static constexpr size_t ring_w = (size_t)S::NSTW * S::STAGE;       // one warp's ring
  // the FMA walk's scaled query heads and p of each tile (none on the mma walk)
  static constexpr size_t q = NW * ring_w;                                 // f32 [GC][D]
  static constexpr size_t p = q + (MMA ? 0 : sizeof(float) * GC * D);      // f32 [NW][GC][TK]
  static constexpr size_t wm = p + (MMA ? 0 : sizeof(float) * NW * GC * S::TK);  // f32 [NW][GC]
  static constexpr size_t wl = wm + sizeof(float) * NW * GC;         // f32 [NW][GC]
  static constexpr size_t bt = wl + sizeof(float) * NW * GC;         // int [M]
  // then, 16-byte aligned, rank 0's slots for the cluster's partials:
  // acc f32 [S][GC][D], m f32 [S][GC], l f32 [S][GC]
  static __host__ __device__ size_t slots(int M) { return (bt + sizeof(int) * M + 15) / 16 * 16; }
  static __host__ __device__ size_t bytes(int M, int S) {
    return slots(M) + sizeof(float) * S * GC * (D + 2);
  }
  // a warp leaves its partial acc [GC][D] in its own ring
  static_assert(sizeof(float) * GC * D <= ring_w, "ring too small");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte chunk of T as EPC floats
template <typename T, int EPC>
__device__ __forceinline__ void chunk_f(const unsigned char* p, float (&f)[EPC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < EPC; ++i) f[i] = to_f(e[i]);
}

// the mma walk is held to 5 blocks an SM (<= 102 registers): left free,
// ptxas spills 12 bytes at GC 1 for no gain
template <typename T, int D, int GC, bool MMA>
__global__ void __launch_bounds__(NT, MMA ? 5 : 1)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ lens, T* __restrict__ out, int H, int K,
                       int ps, int M, int window, float qscale) {
  using Sh = Shape<T, D, MMA>;
  using L = Smem<T, D, GC, MMA>;
  constexpr int TK = Sh::TK, NCH = Sh::NCH, EPC = Sh::EPC, TPK = Sh::TPK;
  constexpr int NSTW = Sh::NSTW, SWZ = Sh::SWZ, SWM = Sh::SWM, AW = Sh::CPL * EPC;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  float* p_s = reinterpret_cast<float*>(smem + L::p);
  float* wm_s = reinterpret_cast<float*>(smem + L::wm);
  float* wl_s = reinterpret_cast<float*>(smem + L::wl);
  int* bt_s = reinterpret_cast<int*>(smem + L::bt);

  // first phase of the cluster barrier: a block may store into rank 0's
  // shared memory only once every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // launched with programmatic stream serialisation: the launch may overlap
  // the previous kernel's tail, and nothing is read before it has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = (int)cluster.num_blocks();
  const int G = H / K;
  const int n_chunks = (G + GC - 1) / GC;
  const int kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * GC;
  const int ng = min(GC, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // the block table's row; the FMA walk's query heads, scaled to base-2 logits
  for (int i = tid; i < M; i += NT) bt_s[i] = block_tables[(size_t)b * M + i];
  if constexpr (!MMA) {
    for (int i = tid; i < GC * D; i += NT) {
      const int g = i / D;
      float v = 0.f;
      if (g < ng) v = to_f(q[((size_t)b * H + kvh * G + g0 + g) * D + i % D]) * qscale;
      q_s[i] = v;
    }
  }

  // this block's share of the kept keys, in whole tiles; warp w takes the
  // share's tiles w, w + NW, ...
  const int len = lens[b];
  const int start = window > 0 ? max(0, len - window) : 0;
  const int end = min(len, M * ps);  // the block table holds no key past M * ps
  const int tb = start / TK;
  const int n_all = max((end + TK - 1) / TK - tb, 0);
  const int t0 = tb + (int)((long long)n_all * rank / S);
  const int n_tiles = tb + (int)((long long)n_all * (rank + 1) / S) - t0;
  const int n_mine = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
  unsigned char* ring = smem + (size_t)warp * L::ring_w;
  float* p_w = p_s + warp * GC * TK;
  __syncthreads();

  // K and V rows of the warp's k-th tile into ring stage `stage` (zeros
  // outside the mask).  Lane t looks up key t's row and the copies take it
  // by shuffle (cp.async's asm would order each lookup after the last copy).
  auto load_tile = [&](int k, int stage) {
    unsigned char* ks = ring + (size_t)stage * Sh::STAGE;
    unsigned char* vs = ks + TK * Sh::ROW;
    long long row = -1;
    const int kpos = (t0 + warp + k * NW) * TK + lane;
    if (lane < TK && kpos >= start && kpos < end)
      row = (((long long)bt_s[kpos / ps] * ps + kpos % ps) * K + kvh) * D;
#pragma unroll
    for (int j = 0; j < TK * NCH / 32; ++j) {
      const int i = lane + 32 * j, t = i / NCH, c = i % NCH;
      const long long r = __shfl_sync(0xffffffffu, row, t);
      const int dst = t * Sh::ROW + (c ^ ((t * SWM) & SWZ)) * 16;
      const size_t off = r < 0 ? 0 : (size_t)r + c * EPC;
      sm90::cp_async16(ks + dst, k_pages + off, r < 0 ? 0 : 16);
      sm90::cp_async16(vs + dst, v_pages + off, r < 0 ? 0 : 16);
    }
  };

#pragma unroll
  for (int st = 0; st < NSTW - 1; ++st) {
    if (st < n_mine) load_tile(st, st);
    sm90::cp_async_commit();
  }

  if constexpr (MMA) {
    // S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32 sums): the
    // block's query heads are the A rows (rows GC..15 are zero), a tile's
    // 16 keys two n-tiles of S and the k-step of P V.  Lane l holds the
    // scores of head l / 4 for keys 2 (l % 4) + {0, 1} of each n-tile.
    constexpr int KS = D / 16, NTO = D / 8;
    const int r = lane >> 2, cq = (lane & 3) * 2;
    uint32_t qa[KS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = qa[ks][1] = 0u;
      if (r < ng) {
        const T* qr = q + ((size_t)b * H + kvh * G + g0 + r) * D + ks * 16 + cq;
        qa[ks][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
      }
    }
    float m = NEG_INF, l = 0.f, o[NTO][4];
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    // ldmatrix's row for this lane: matrix j = lane / 8, row lane % 8
    const int lj = lane >> 3, lr = lane & 7;
    const int k_key = (lj >> 1) * 8 + lr, k_dc = lj & 1;  // K: (n-tile, k half)
    const int v_key = (lj & 1) * 8 + lr, v_dc = lj >> 1;  // V^T: (k half, n-tile)

    for (int k = 0; k < n_mine; ++k) {
      sm90::cp_async_wait<NSTW - 2>();
      __syncwarp();  // tile k landed; every lane is done with tile k - 1
      if (k + NSTW - 1 < n_mine) load_tile(k + NSTW - 1, (k + NSTW - 1) % NSTW);
      sm90::cp_async_commit();
      const unsigned char* ks_ = ring + (size_t)(k % NSTW) * Sh::STAGE;
      const unsigned char* vs = ks_ + TK * Sh::ROW;

      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        const int c = ks * 2 + k_dc;
        sm90::ldmatrix_x4(kb, ks_ + k_key * Sh::ROW + (c ^ (k_key & SWZ)) * 16);
        const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        sm90::mma_bf16_16816(sc[0], a, kb[0], kb[1]);
        sm90::mma_bf16_16816(sc[1], a, kb[2], kb[3]);
      }
      const int kbase = (t0 + warp + k * NW) * TK + cq;
      float s[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kbase + (j >> 1) * 8 + (j & 1);
        s[j] = kpos >= start && kpos < end ? sc[j >> 1][j & 1] * qscale : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt) {
        o[nt][0] *= alpha;
        o[nt][1] *= alpha;
      }
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = exp2f(s[j] - m);
        l += p[j];
      }
      const uint32_t pa[4] = {sm90::pack_bf16(p[0], p[1]), 0u, sm90::pack_bf16(p[2], p[3]), 0u};
#pragma unroll
      for (int np = 0; np < NTO / 2; ++np) {
        uint32_t vb[4];
        const int c = np * 2 + v_dc;
        sm90::ldmatrix_x4_trans(vb, vs + v_key * Sh::ROW + (c ^ (v_key & SWZ)) * 16);
        sm90::mma_bf16_16816(o[2 * np], pa, vb[0], vb[1]);
        sm90::mma_bf16_16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    sm90::cp_async_wait<0>();
    __syncwarp();  // the warp's ring is free: it takes the warp's partial

    // the warp's partial: l summed over the four lanes of a head
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float* wacc = reinterpret_cast<float*>(ring);  // [GC][D]
    if (r < ng) {
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt)
        *reinterpret_cast<float2*>(wacc + r * D + nt * 8 + cq) = make_float2(o[nt][0], o[nt][1]);
      if (cq == 0) {
        wm_s[warp * GC + r] = m;
        wl_s[warp * GC + r] = l;
      }
    }
  } else {
    float m[GC], l[GC], acc[GC][AW];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < AW; ++e) acc[g][e] = 0.f;
    }
    const int s_key = lane / TPK, s_c = lane % TPK;  // scores: (key, chunk lane)
    const int v_c = NCH < 32 ? lane % NCH : lane;    // P V: (chunk, key subset)
    const int v_sub = NCH < 32 ? lane / NCH : 0;

    for (int k = 0; k < n_mine; ++k) {
      sm90::cp_async_wait<NSTW - 2>();
      __syncwarp();  // tile k landed; every lane is done with tile k - 1
      if (k + NSTW - 1 < n_mine) load_tile(k + NSTW - 1, (k + NSTW - 1) % NSTW);
      sm90::cp_async_commit();
      const unsigned char* ks = ring + (size_t)(k % NSTW) * Sh::STAGE;
      const unsigned char* vs = ks + TK * Sh::ROW;

      // scores of the tile's TK keys
      float dot[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) dot[g] = 0.f;
#pragma unroll
      for (int j = 0; j < Sh::CPT; ++j) {
        const int c = s_c + j * TPK;
        float kf[EPC];
        chunk_f<T, EPC>(ks + s_key * Sh::ROW + (c ^ ((s_key * SWM) & SWZ)) * 16, kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4* qg = reinterpret_cast<const float4*>(q_s + g * D + c * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 qv = qg[e];
            dot[g] = fmaf(qv.x, kf[4 * e], dot[g]);
            dot[g] = fmaf(qv.y, kf[4 * e + 1], dot[g]);
            dot[g] = fmaf(qv.z, kf[4 * e + 2], dot[g]);
            dot[g] = fmaf(qv.w, kf[4 * e + 3], dot[g]);
          }
        }
      }
      const int kpos = (t0 + warp + k * NW) * TK + s_key;
      const bool keep = kpos >= start && kpos < end;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float s = dot[g];
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        s = keep ? s : NEG_INF;
        float mx = s;
#pragma unroll
        for (int o = TPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (mx > m[g]) {  // warp-uniform: rescale only when the max moves
          const float alpha = exp2f(m[g] - mx);
          m[g] = mx;
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < AW; ++e) acc[g][e] *= alpha;
        }
        const float p = exp2f(s - m[g]);
        if (s_c == 0) {
          p_w[g * TK + s_key] = p;
          l[g] += p;
        }
      }
      __syncwarp();

      // P V
#pragma unroll
      for (int j = 0; j < Sh::KPL; ++j) {
        const int t = v_sub + j * Sh::SUBW;
#pragma unroll
        for (int cc = 0; cc < Sh::CPL; ++cc) {
          const int c = v_c + 32 * cc;
          float vf[EPC];
          chunk_f<T, EPC>(vs + t * Sh::ROW + (c ^ ((t * SWM) & SWZ)) * 16, vf);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float p = p_w[g * TK + t];
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              acc[g][cc * EPC + e] = fmaf(p, vf[e], acc[g][cc * EPC + e]);
          }
        }
      }
    }
    sm90::cp_async_wait<0>();
    __syncwarp();  // the warp's ring is free: it takes the warp's partial

    // the warp's partial: l summed over the lanes, acc over the key subsets
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int o = NCH; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < AW; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
    float* wacc = reinterpret_cast<float*>(ring);  // [GC][D]
    if (v_sub == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int cc = 0; cc < Sh::CPL; ++cc) {
          float4* dst = reinterpret_cast<float4*>(wacc + g * D + (v_c + 32 * cc) * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e)
            dst[e] = make_float4(acc[g][cc * EPC + 4 * e], acc[g][cc * EPC + 4 * e + 1],
                                 acc[g][cc * EPC + 4 * e + 2], acc[g][cc * EPC + 4 * e + 3]);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        wm_s[warp * GC + g] = m[g];
        wl_s[warp * GC + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's partial (the warps' merged in a fixed order), pushed into
  // rank 0's slot for this rank through distributed shared memory
  float* slot_acc = reinterpret_cast<float*>(smem + L::slots(M));
  float* slot_m = slot_acc + S * GC * D;
  float* slot_l = slot_m + S * GC;
  float* to_acc = cluster.map_shared_rank(slot_acc, 0) + rank * GC * D;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < ng * D; i += NT) {
    const int g = i / D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm_s[w * GC + g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a = fmaf(reinterpret_cast<const float*>(smem + (size_t)w * L::ring_w)[i],
               exp2f(wm_s[w * GC + g] - mx), a);
    to_acc[i] = a;
  }
  if (tid < ng) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm_s[w * GC + tid]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a = fmaf(wl_s[w * GC + tid], exp2f(wm_s[w * GC + tid] - mx), a);
    cluster.map_shared_rank(slot_m, 0)[rank * GC + tid] = mx;
    cluster.map_shared_rank(slot_l, 0)[rank * GC + tid] = a;
  }
  cluster.sync();  // every rank's partial has landed in rank 0's slots

  // rank 0 merges the S partials and writes the output
  if (rank == 0) {
    for (int i = tid; i < ng * D; i += NT) {
      const int g = i / D;
      float mx = NEG_INF;
      for (int r = 0; r < S; ++r) mx = fmaxf(mx, slot_m[r * GC + g]);
      float lsum = 0.f, a = 0.f;
      for (int r = 0; r < S; ++r) {
        const float c = exp2f(slot_m[r * GC + g] - mx);
        lsum = fmaf(slot_l[r * GC + g], c, lsum);
        a = fmaf(slot_acc[r * GC * D + i], c, a);
      }
      const int h = kvh * G + g0 + g;
      out[((size_t)b * H + h) * D + i % D] = from_f<T>(a / fmaxf(lsum, 1e-30f));
    }
  }
}

template <typename T, int D, int GC, bool MMA>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const int* bt,
                         const int* lens, void* out, int B, int H, int K, int ps, int M,
                         int window, int splits, cudaStream_t stream) {
  using L = Smem<T, D, GC, MMA>;
  const size_t bytes = L::bytes(M, splits);
  static size_t allowed = 0;  // the dynamic shared memory the kernel may use so far
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, D, GC, MMA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(paged_attention_kernel<T, D, GC, MMA>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  const int G = H / K;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, K * ((G + GC - 1) / GC), B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const float qscale = LOG2E / sqrtf((float)D);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<T, D, GC, MMA>, static_cast<const T*>(q),
      static_cast<const T*>(kp), static_cast<const T*>(vp), bt, lens, static_cast<T*>(out), H,
      K, ps, M, window, qscale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the instance that serves gc query heads a block (gc in 1..MAX_GC) on
// the walk asked for
template <typename T, int D, int GC = 1>
cudaError_t launch_gc(int gc, int use_mma, const void* q, const void* kp, const void* vp,
                      const int* bt, const int* lens, void* out, int B, int H, int K, int ps,
                      int M, int window, int splits, cudaStream_t s) {
  if constexpr (GC < MAX_GC) {
    if (gc != GC)
      return launch_gc<T, D, GC + 1>(gc, use_mma, q, kp, vp, bt, lens, out, B, H, K, ps, M,
                                     window, splits, s);
  }
  if (use_mma) {
    if constexpr (mma_takes<T, D>())
      return launch_typed<T, D, GC, true>(q, kp, vp, bt, lens, out, B, H, K, ps, M, window,
                                          splits, s);
    return cudaErrorInvalidValue;
  }
  return launch_typed<T, D, GC, false>(q, kp, vp, bt, lens, out, B, H, K, ps, M, window, splits,
                                       s);
}

template <typename T>
cudaError_t launch_t(int D, int gc, int use_mma, const void* q, const void* kp, const void* vp,
                     const int* bt, const int* lens, void* out, int B, int H, int K, int ps,
                     int M, int window, int splits, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_gc<T, 32>(gc, use_mma, q, kp, vp, bt, lens, out, B, H, K, ps, M, window,
                              splits, s);
    case 64:
      return launch_gc<T, 64>(gc, use_mma, q, kp, vp, bt, lens, out, B, H, K, ps, M, window,
                              splits, s);
    case 128:
      return launch_gc<T, 128>(gc, use_mma, q, kp, vp, bt, lens, out, B, H, K, ps, M, window,
                               splits, s);
    case 256:
      return launch_gc<T, 256>(gc, use_mma, q, kp, vp, bt, lens, out, B, H, K, ps, M, window,
                               splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,1,H,D), k_pages/v_pages (P,ps,K,D), block_tables (B,M) int32,
// lens (B,) int32, out (B,1,H,D); all contiguous, one dtype (f32 or bf16),
// q/k/v 16-byte aligned.  D must be 32, 64, 128 or 256; splits (the cluster
// size) 1, 2, 4 or 8; use_mma 1 for the mma walk (bf16 at D 64 or 128
// only), 0 for the FMA walk.  window <= 0 means no window.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* lens, void* out,
                                      int B, int H, int K, int D, int ps, int M, int window,
                                      int splits, int use_mma, int is_bf16, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int gc = G < MAX_GC ? G : MAX_GC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lens);
  cudaError_t err =
      is_bf16 ? launch_t<__nv_bfloat16>(D, gc, use_mma, q, k_pages, v_pages, bt, ln, out, B, H, K,
                                        ps, M, window, splits, s)
              : launch_t<float>(D, gc, use_mma, q, k_pages, v_pages, bt, ln, out, B, H, K, ps, M,
                                window, splits, s);
  return (int)err;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
