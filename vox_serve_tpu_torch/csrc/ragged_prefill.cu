// K3: ragged (segment-masked) causal prefill attention, for Hopper (sm_90a).
//
// Replaces vox_serve_tpu/ops/pallas_prefill.py `_pallas_prefill_call`
// (kernel `_prefill_kernel`, wrapper `pallas_ragged_prefill`). Prompts are
// packed token-wise into one T-token buffer with segment ids; token i
// attends token j iff seg[i] == seg[j] >= 0 and j <= i in buffer order
// (segments are contiguous spans, so buffer order is causal order). Rows
// with seg < 0 are padding and their output is not defined by the contract;
// this kernel writes zeros there.
//
// What bounds it on an H100: at the serving shapes (tens to hundreds of
// tokens per prompt, one launch per talker layer) latency: one trip to
// memory for Q and the first K/V tile, a few tiles of products, the write.
// The bytes (q, k, v, out once) bound it from below at every T; the
// products only pass them at long prompts.
//
// Design, FlashAttention-2 on the tensor cores:
//   * one CTA per (query tile, KV head). The tile's BM = 16 * warps rows
//     hold all G query heads of the KV group: row r is head r / BQ of token
//     t0 + r % BQ (BQ = floor(BM / G)), so each K/V tile staged serves all G
//     heads. Where G does not divide BM (G = 3: 63 of 64 rows, 21 tokens;
//     G = 7: 63 of 64 or 28 of 32), the BM - G * BQ < G rows left over load
//     nothing, see no key (their scores are -inf, their sums 0) and store
//     nothing. Those checks live in their own instance (kRagged): where G
//     divides BM (G = 1, 2, 4, 8, 16) the kernel is compiled without them
//     and is the same machine code as before they existed (compiled with
//     them, the 2-warp instance dropped from 217 to 169 registers and
//     measured 7.7-8.1 us at T = 168, G = 2 on an H100, against 7.1).
//     ops/kernels.py plan_prefill_tiles picks 4 warps (BM 64) where that
//     grid fills the SMs and 2 warps (BM 32) otherwise;
//   * QK^T and PV run as bf16 mma.sync.m16n8k16 with f32 accumulators; the
//     operands come from shared memory by ldmatrix (V by ldmatrix.trans),
//     each fragment loaded two steps ahead of its products, and P goes from
//     the score accumulators straight into A fragments (bf16, as in
//     FlashAttention: the output is bf16 too);
//   * Q and K/V tiles of 64 keys are staged by cp.async, K/V in a double-
//     buffered ring: the next tile's copies are issued before the current
//     tile is computed. Rows are 128 dims (256 bytes) with their 16-byte
//     chunks XOR-swizzled by (row % 8), so ldmatrix is free of bank
//     conflicts. D < 128 (a multiple of 8) zero-fills the chunks past D;
//   * ragged and causal skipping: since segments are contiguous, row i sees
//     exactly the keys [start of its segment, i]. The CTA derives its key
//     range [start of its first valid row's segment, last valid row + 1)
//     from the segment ids, with no host sync and any T, and walks it from
//     the diagonal down: the first tile's copies go out as soon as the
//     rows are read, and the backward search for the segment start runs
//     while they land. A warp skips a tile outside all of its rows' ranges;
//     the element mask (two compares against the row's range, padding rows
//     see nothing) runs only on tiles that straddle a diagonal or a segment
//     edge, tiles inside every row's range take the unmasked path;
//   * online softmax in f32, base 2 with log2(e) folded into the scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kRowChunks = kMaxD / 8;   // 16-byte chunks per staged row
constexpr int kBN = 64;                 // keys per tile
constexpr int kMaxBQ = 64;              // tokens per query tile (G = 1)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRowChunks + (chunk ^ (row & 7));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, unsigned& r0,
                                          unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kWarps>
constexpr int smem_bytes() {
  // Q tile + two stages of (K, V) tiles, 256-byte rows
  return (16 * kWarps + 2 * 2 * kBN) * kRowChunks * 16;
}

// kRagged: G does not divide 16 * kWarps, so G * BQ < BM rows hold work.
template <int kWarps, bool kRagged>
__global__ void __launch_bounds__(kWarps * 32)
ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ out,
                      int T, int H, int KH, int D, float scale_log2) {
  constexpr int BM = 16 * kWarps;
  constexpr int NT = kWarps * 32;
  constexpr int kSteps = (kMaxD / 16) * (kBN / 16);  // ldmatrix.x4 per pass
  extern __shared__ uint4 smem[];
  uint4* qs = smem;                         // [BM][16] swizzled
  uint4* kvs = smem + BM * kRowChunks;      // [stage][K, V][kBN][16]
  __shared__ int tok_seg[kMaxBQ];
  __shared__ int tok_lo[kMaxBQ];            // first key a token sees
  __shared__ int s_first, s_hi, s_miss;

  const int G = H / KH;
  const int BQ = BM / G;
  const int GB = kRagged ? G * BQ : BM;  // rows that hold a (head, token)
  const int t0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchunks = D / 8;

  // Q tile: row r = head (h*G + r / BQ) of token t0 + r % BQ. The copies
  // join the first K/V tile's group.
  for (int idx = tid; idx < BM * kRowChunks; idx += NT) {
    const int r = idx / kRowChunks;
    const int c = idx - r * kRowChunks;
    const int t = t0 + r % BQ;
    const bool ok = (!kRagged || r < GB) && t < T && c < nchunks;
    const __nv_bfloat16* src =
        ok ? q + ((int64_t)t * H + (int64_t)h * G + r / BQ) * D + c * 8 : q;
    cp_async16(qs + swz(r, c), src, ok);
  }
  if (tid < BQ) {
    const int t = t0 + tid;
    tok_seg[tid] = t < T ? seg[t] : -1;
  }
  __syncthreads();
  if (warp == 0) {
    int lo_t = INT_MAX, hi_t = 0;
#pragma unroll
    for (int c = 0; c < kMaxBQ / 32; ++c) {
      const int tq = lane + 32 * c;
      if (tq < BQ && tok_seg[tq] >= 0) {
        lo_t = min(lo_t, t0 + tq);
        hi_t = max(hi_t, t0 + tq + 1);
      }
    }
    lo_t = __reduce_min_sync(0xffffffffu, lo_t);
    hi_t = __reduce_max_sync(0xffffffffu, hi_t);
    if (lane == 0) {
      s_first = lo_t;
      s_hi = hi_t;
      s_miss = -1;
    }
  }
  __syncthreads();
  const int first = s_first;
  const int hi = s_hi;

  auto issue = [&](int kt, int stage) {
    uint4* ks = kvs + stage * 2 * kBN * kRowChunks;
    uint4* vs = ks + kBN * kRowChunks;
    for (int idx = tid; idx < kBN * kRowChunks; idx += NT) {
      const int j = idx / kRowChunks;
      const int c = idx - j * kRowChunks;
      const int t = kt + j;
      const bool ok = t >= 0 && t < T && c < nchunks;
      const int64_t off = ok ? ((int64_t)t * KH + h) * D + c * 8 : 0;
      cp_async16(ks + swz(j, c), k + off, ok);
      cp_async16(vs + swz(j, c), v + off, ok);
    }
    cp_async_commit();
  };

  // key tiles run from the diagonal down: the first one is known as soon as
  // the rows are, and loads while the segment start is searched
  int lo = hi;
  if (first != INT_MAX) {
    issue(hi - kBN, 0);
    // the first valid row's segment start: scan back from it in blocks of
    // 4 * NT keys for the nearest key of another segment (or index -1)
    const int sid = tok_seg[first - t0];
    for (int base = first;; base -= 4 * NT) {
      int miss = INT_MIN;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = base - 1 - tid - u * NT;
        if (j < 0)
          miss = max(miss, -1);
        else if (seg[j] != sid)
          miss = max(miss, j);
      }
      if (miss != INT_MIN) atomicMax(&s_miss, miss);
      if (__syncthreads_or(miss != INT_MIN)) break;
    }
    lo = s_miss + 1;
  } else {
    cp_async_commit();
  }
  // each token's first visible key: its segment's start (the block's first
  // valid token starts at lo; a later segment starts inside the block)
  if (warp == 0) {
    int carry = INT_MIN;
#pragma unroll
    for (int c = 0; c < kMaxBQ / 32; ++c) {
      const int tq = lane + 32 * c;
      const int s = tq < BQ ? tok_seg[tq] : -1;
      int val = INT_MIN;
      if (s >= 0) {
        if (tq == 0)
          val = lo;
        else if (tok_seg[tq - 1] != s)
          val = t0 + tq;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, val, o);
        if (lane >= o) val = max(val, up);
      }
      val = max(val, carry);
      carry = __shfl_sync(0xffffffffu, val, 31);
      if (tq < BQ) tok_lo[tq] = s >= 0 ? val : INT_MAX;
    }
  }
  __syncthreads();

  // this thread's two accumulator rows see keys [rlo, rhi]; its warp's 16
  // rows, the summary that classifies a tile
  const int ra = warp * 16 + (lane >> 2);
  int rlo[2], rhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = (ra + 8 * i) % BQ;
    const bool live = !kRagged || ra + 8 * i < GB;
    rlo[i] = live ? tok_lo[tq] : INT_MAX;
    rhi[i] = live && tok_seg[tq] >= 0 ? t0 + tq : -1;
  }
  int wlo_min, wlo_max, whi_min, whi_max;
  bool w_any, w_all;
  {
    const int r = warp * 16 + (lane & 15);
    const int tq = r % BQ;
    const bool ok = (!kRagged || r < GB) && tok_seg[tq] >= 0;
    const int lo_r = tok_lo[tq];
    const int hi_r = t0 + tq;
    w_any = __any_sync(0xffffffffu, ok);
    w_all = __all_sync(0xffffffffu, ok);
    wlo_min = __reduce_min_sync(0xffffffffu, ok ? lo_r : INT_MAX);
    wlo_max = __reduce_max_sync(0xffffffffu, ok ? lo_r : -1);
    whi_min = __reduce_min_sync(0xffffffffu, ok ? hi_r : INT_MAX);
    whi_max = __reduce_max_sync(0xffffffffu, ok ? hi_r : -1);
  }

  unsigned qf[kMaxD / 16][4];
  float oacc[kMaxD / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  int stage = 0;
  for (int kt = hi - kBN; kt + kBN > lo; kt -= kBN) {
    const int nkt = kt - kBN;
    if (nkt + kBN > lo) {
      issue(nkt, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == hi - kBN) {
#pragma unroll
      for (int kd = 0; kd < kMaxD / 16; ++kd) {
        const int r = warp * 16 + (lane & 15);
        ldsm_x4(qs + swz(r, kd * 2 + (lane >> 4)), qf[kd][0], qf[kd][1],
                qf[kd][2], qf[kd][3]);
      }
    }
    const bool skip = !w_any || kt > whi_max || kt + kBN - 1 < wlo_min;
    if (!skip) {
      const uint4* ks = kvs + stage * 2 * kBN * kRowChunks;
      const uint4* vs = ks + kBN * kRowChunks;
      // S = Q K^T; step s: dims (s / 4) * 16, keys (s % 4) * 16. The K
      // fragments are loaded two steps ahead of their products.
      float sacc[kBN / 8][4];
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
      unsigned kb[3][4];
      auto load_k = [&](int st, unsigned (&b)[4]) {
        const int j = (st % 4) * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(ks + swz(j, (st / 4) * 2 + ((lane >> 3) & 1)), b[0], b[1],
                b[2], b[3]);
      };
      load_k(0, kb[0]);
      load_k(1, kb[1]);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st + 2 < kSteps) load_k(st + 2, kb[(st + 2) % 3]);
        const unsigned* b = kb[st % 3];
        mma_bf16(sacc[2 * (st % 4)], qf[st / 4], b[0], b[1]);
        mma_bf16(sacc[2 * (st % 4) + 1], qf[st / 4], b[2], b[3]);
      }
      // scale (base 2) and mask: element e of tile n is row ra + 8*(e/2),
      // key kt + n*8 + (lane&3)*2 + e%2; a tile inside every row's range
      // of the warp takes no mask
      const bool full = w_all && kt >= wlo_max && kt + kBN - 1 <= whi_min;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[n][e] * scale_log2;
          if (!full) {
            const int key = kt + n * 8 + (lane & 3) * 2 + (e & 1);
            if (key < rlo[e >> 1] || key > rhi[e >> 1]) x = -INFINITY;
          }
          sacc[n][e] = x;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
          mx = fmaxf(mx, fmaxf(sacc[n][2 * i], sacc[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row with nothing visible yet keeps p = 0 and no NaN
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = fast_exp2(m[i] - m_use);
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
          sacc[n][2 * i] = fast_exp2(sacc[n][2 * i] - m_use);
          sacc[n][2 * i + 1] = fast_exp2(sacc[n][2 * i + 1] - m_use);
          ps += sacc[n][2 * i] + sacc[n][2 * i + 1];
        }
        l[i] = l[i] * alpha + ps;  // this thread's columns; summed at the end
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < kMaxD / 8; ++n) {
          oacc[n][2 * i] *= alpha;
          oacc[n][2 * i + 1] *= alpha;
        }
      }
      // O += P V: P's accumulators are the A fragments of 16-key steps;
      // step s: keys (s / 8) * 16, dims (s % 8) * 16, V fragments two steps
      // ahead
      unsigned pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
        pa[kk][1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
        pa[kk][2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
      }
      unsigned vb[3][4];
      auto load_v = [&](int st, unsigned (&b)[4]) {
        const int j = (st / 8) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(vs + swz(j, (st % 8) * 2 + (lane >> 4)), b[0], b[1], b[2],
                  b[3]);
      };
      load_v(0, vb[0]);
      load_v(1, vb[1]);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st + 2 < kSteps) load_v(st + 2, vb[(st + 2) % 3]);
        const unsigned* b = vb[st % 3];
        mma_bf16(oacc[2 * (st % 8)], pa[st / 8], b[0], b[1]);
        mma_bf16(oacc[2 * (st % 8) + 1], pa[st / 8], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float L = l[i];
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    const float inv = L > 0.f ? 1.f / L : 0.f;
    const int r = ra + 8 * i;
    const int t = t0 + r % BQ;
    if ((kRagged && r >= GB) || t >= T) continue;
    __nv_bfloat16* o =
        out + ((int64_t)t * H + (int64_t)h * G + r / BQ) * D;
#pragma unroll
    for (int n = 0; n < kMaxD / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
            oacc[n][2 * i] * inv, oacc[n][2 * i + 1] * inv);
    }
  }
}

template <int kWarps, bool kRagged>
int launch_k(const void* q, const void* k, const void* v, const void* seg,
             void* out, int T, int H, int KH, int D, float scale,
             void* stream) {
  constexpr int bytes = smem_bytes<kWarps>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ragged_prefill_kernel<kWarps, kRagged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int BQ = 16 * kWarps / (H / KH);
  dim3 grid((T + BQ - 1) / BQ, KH);
  ragged_prefill_kernel<kWarps, kRagged><<<grid, kWarps * 32, bytes,
                                           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out, T, H,
      KH, D, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int kWarps>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* out, int T, int H, int KH, int D, float scale,
           void* stream) {
  if ((16 * kWarps) % (H / KH))
    return launch_k<kWarps, true>(q, k, v, seg, out, T, H, KH, D, scale,
                                  stream);
  return launch_k<kWarps, false>(q, k, v, seg, out, T, H, KH, D, scale,
                                 stream);
}

}  // namespace

// Plain C entry, loaded with ctypes. `warps` (2 or 4) is the query tile of
// ops/kernels.py plan_prefill_tiles: 16 * warps rows hold G heads x
// floor(16 * warps / G) tokens. Returns cudaGetLastError() after the launch
// (0 = success), -1 for a tile that cannot hold one token of the head group
// (G > 16 * warps).
extern "C" int vox_ragged_prefill_attention(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    int T, int H, int KH, int D, float scale, int warps, void* stream) {
  if (T == 0) return 0;
  const int G = H / KH;
  if (D > kMaxD || D % 8 || G < 1 || G > 16 * warps) return -1;
  switch (warps) {
    case 2: return launch<2>(q, k, v, seg, out, T, H, KH, D, scale, stream);
    case 4: return launch<4>(q, k, v, seg, out, T, H, KH, D, scale, stream);
    default: return -1;
  }
}
