// The placement annealer's proposal scorer, from the swap list. The table M
// (b groups x v nodes, int8 0/1), its Gram G = M^T M (v x v, int32, zero
// diagonal), the histogram hist[t] of G's values over the unordered pairs
// i < j, the per-(group, domain) member counts and the current scores
// state = (overflow, max, sum of squares), int64, stay on the card. A move
// p is (g1, g2, a, c, valid): row g1 gives node a to row g2 and takes node
// c from it. Proposal p's table differs from M in those 4 entries, so
// with d[x] = M[g2][x] - M[g1][x] for x not in {a, c} (and d = 0 there):
//   G'[a][x] = G[a][x] + d[x],  G'[c][x] = G[c][x] - d[x],
// and nothing else of G changes (G[a][c] and the diagonal keep their
// values). Each changed pair moves by exactly 1. So, summing over x:
//   ssq' = ssq + 2 * sum (2 d (G[a][x] - G[c][x]) + 2 d^2)
//   max' = max + 1 if a changed pair reaches max + 1; else max if
//          hist[max] - (changed pairs leaving max) + (arriving) > 0;
//          else max - 1
//   over' = over + the change of max(count - cap, 0) in the 4 cells
//           (g1, dom a), (g1, dom c), (g2, dom c), (g2, dom a)
// and an invalid move scores as M. ssq is returned wrapped to int32, as
// XLA's int32 sum wraps; the state keeps it exact.
//
// Replaces the XLA-lowered score_batch of tpu3fs/placement/solver.py
// (:205-220), which took the full Gram of every materialised proposal;
// swap_score_kernel computes the same (over, max, ssq). swap_apply_kernel
// replaces the accept step's `M = cand[bi]` (:261): it applies one move to
// the state on the card.
//
// Bound on this card: launch latency. A proposal reads 2 rows of M and 2
// rows of G, 10 v bytes: at P = 128, v = 180 that is 230,400 bytes,
// 0.069 us at 3.35 TB/s, and the operations are fewer still. G (130 KB at
// v = 180) stays in the 50 MB L2 between steps.
//
// Design: one warp per proposal, lanes striding over the v nodes
// (neighbouring lanes on neighbouring bytes of M and words of G), the sums
// and counts reduced with warp shuffles, lane 0 writing the three scores.
// The apply kernel is one block: its threads stride over the nodes, update
// rows and columns a and c of G (kept symmetric) and move each changed
// pair between hist's bins with atomics; after a barrier one thread writes
// the 4 entries of M and of the counts and the new scores. It runs on the
// caller's stream, so the next score launch sees its writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // score kernel: proposals per block
constexpr int kApplyThreads = 256;     // apply kernel: its one block
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxBlocks = 2147483647LL;

struct Move {
  long long g1, g2, a, c;
  int valid;
};

__device__ __forceinline__ Move load_move(const int* __restrict__ moves,
                                          long long P, long long p) {
  return {moves[p], moves[P + p], moves[2 * P + p], moves[3 * P + p],
          moves[4 * P + p]};
}

__device__ __forceinline__ long long excess(long long n, long long cap) {
  return n > cap ? n - cap : 0;
}

// The change of the domain overflow that move m makes; 0 without domains
// or when a and c share a domain.
__device__ long long overflow_delta(const int* __restrict__ counts,
                                    const int* __restrict__ dom, long long D,
                                    long long cap, const Move& m) {
  if (D == 0) return 0;
  const long long da = dom[m.a], dc = dom[m.c];
  if (da == dc) return 0;
  const long long c1a = counts[m.g1 * D + da], c1c = counts[m.g1 * D + dc];
  const long long c2a = counts[m.g2 * D + da], c2c = counts[m.g2 * D + dc];
  return excess(c1a - 1, cap) - excess(c1a, cap) + excess(c1c + 1, cap) -
         excess(c1c, cap) + excess(c2c - 1, cap) - excess(c2c, cap) +
         excess(c2a + 1, cap) - excess(c2a, cap);
}

__global__ void __launch_bounds__(kWarps * 32)
swap_score_kernel(const int8_t* __restrict__ M, const int* __restrict__ G,
                  const int* __restrict__ hist, const int* __restrict__ counts,
                  const int* __restrict__ dom,
                  const long long* __restrict__ state,
                  const int* __restrict__ moves, int* __restrict__ out,
                  long long P, long long v, long long D, long long cap) {
  const int lane = threadIdx.x % 32;
  const long long p =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (p >= P) return;  // the whole warp: p is the warp's
  const Move m = load_move(moves, P, p);
  const long long mx = state[1];
  long long dsum = 0;  // sum over x of 2 d (G[a][x] - G[c][x]) + 2 d^2
  int leave = 0, arrive = 0, up = 0;
  if (m.valid) {
    const int8_t* r1 = M + m.g1 * v;
    const int8_t* r2 = M + m.g2 * v;
    const int* ga_row = G + m.a * v;
    const int* gc_row = G + m.c * v;
    for (long long x = lane; x < v; x += 32) {
      if (x == m.a || x == m.c) continue;
      const int d = r2[x] - r1[x];
      if (d == 0) continue;
      const long long ga = ga_row[x], gc = gc_row[x];
      const long long na = ga + d, nc = gc - d;
      dsum += 2 * d * (ga - gc) + 2;
      up |= (na == mx + 1) | (nc == mx + 1);
      leave += (ga == mx) + (gc == mx);
      arrive += (na == mx) + (nc == mx);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    dsum += __shfl_xor_sync(kFull, dsum, off);
  leave = __reduce_add_sync(kFull, leave);
  arrive = __reduce_add_sync(kFull, arrive);
  up = __any_sync(kFull, up);
  if (lane == 0) {
    long long over = state[0], best = mx, ssq = state[2];
    if (m.valid) {
      over += overflow_delta(counts, dom, D, cap, m);
      best = up ? mx + 1 : (hist[mx] - leave + arrive > 0 ? mx : mx - 1);
      ssq += 2 * dsum;
    }
    out[p] = static_cast<int>(over);
    out[P + p] = static_cast<int>(best);
    out[2 * P + p] = static_cast<int>(static_cast<unsigned>(ssq));  // mod 2^32
  }
}

__global__ void __launch_bounds__(kApplyThreads)
swap_apply_kernel(int8_t* __restrict__ M, int* __restrict__ G,
                  int* __restrict__ hist, int* __restrict__ counts,
                  const int* __restrict__ dom, long long* __restrict__ state,
                  const int* __restrict__ moves, long long P, long long p,
                  long long v, long long D, long long cap) {
  __shared__ long long warp_sum[kApplyThreads / 32];
  __shared__ int fits;
  const Move m = load_move(moves, P, p);
  if (threadIdx.x == 0)  // a move that does not fit M leaves the state alone
    fits = m.valid && M[m.g1 * v + m.a] == 1 && M[m.g2 * v + m.a] == 0 &&
           M[m.g1 * v + m.c] == 0 && M[m.g2 * v + m.c] == 1;
  __syncthreads();
  if (!fits) return;  // the whole block
  const int8_t* r1 = M + m.g1 * v;
  const int8_t* r2 = M + m.g2 * v;
  int* ga_row = G + m.a * v;
  int* gc_row = G + m.c * v;
  long long dsum = 0;
  // thread x alone reads and writes G[a][x], G[x][a], G[c][x], G[x][c]
  for (long long x = threadIdx.x; x < v; x += kApplyThreads) {
    if (x == m.a || x == m.c) continue;
    const int d = r2[x] - r1[x];
    if (d == 0) continue;
    const int ga = ga_row[x], gc = gc_row[x];
    const int na = ga + d, nc = gc - d;
    ga_row[x] = na;
    G[x * v + m.a] = na;
    gc_row[x] = nc;
    G[x * v + m.c] = nc;
    atomicSub(hist + ga, 1);
    atomicAdd(hist + na, 1);
    atomicSub(hist + gc, 1);
    atomicAdd(hist + nc, 1);
    dsum += 2LL * d * (ga - gc) + 2;
  }
  for (int off = 16; off > 0; off >>= 1)
    dsum += __shfl_xor_sync(kFull, dsum, off);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = dsum;
  __syncthreads();  // every read of rows g1 and g2, every hist update done
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < kApplyThreads / 32; ++w) total += warp_sum[w];
    const long long dover = overflow_delta(counts, dom, D, cap, m);
    if (D > 0 && dom[m.a] != dom[m.c]) {
      const long long da = dom[m.a], dc = dom[m.c];
      counts[m.g1 * D + da] -= 1;
      counts[m.g1 * D + dc] += 1;
      counts[m.g2 * D + dc] -= 1;
      counts[m.g2 * D + da] += 1;
    }
    M[m.g1 * v + m.a] = 0;
    M[m.g1 * v + m.c] = 1;
    M[m.g2 * v + m.c] = 0;
    M[m.g2 * v + m.a] = 1;
    const long long mx = state[1];
    state[0] += dover;
    state[1] = hist[mx + 1] > 0 ? mx + 1 : (hist[mx] > 0 ? mx : mx - 1);
    state[2] += 2 * total;
  }
}

}  // namespace

// M: (b, v) int8; G: (v, v) int32; hist: (L,) int32 with L > max + 1;
// counts: (b, D) int32 and dom: (v,) int32 in [0, D), or both null with
// D = 0; state: (3,) int64; moves: (5, P) int32, rows g1, g2, a, c, valid;
// out: (3, P) int32, rows overflow, max, ssq.
extern "C" int tpu3fs_swap_score(const void* M, const void* G,
                                 const void* hist, const void* counts,
                                 const void* dom, const void* state,
                                 const void* moves, void* out, long long P,
                                 long long v, long long D, long long cap,
                                 void* stream) {
  if (P <= 0) return 0;
  if (v <= 0 || D < 0 || (D > 0 && (!counts || !dom)))
    return cudaErrorInvalidValue;
  const long long blocks = (P + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  swap_score_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(M), static_cast<const int*>(G),
      static_cast<const int*>(hist), static_cast<const int*>(counts),
      static_cast<const int*>(dom), static_cast<const long long*>(state),
      static_cast<const int*>(moves), static_cast<int*>(out), P, v, D, cap);
  return static_cast<int>(cudaGetLastError());
}

// The same tensors, updated in place by move p of moves (5, P).
extern "C" int tpu3fs_swap_apply(void* M, void* G, void* hist, void* counts,
                                 const void* dom, void* state,
                                 const void* moves, long long P, long long p,
                                 long long v, long long D, long long cap,
                                 void* stream) {
  if (p < 0 || p >= P || v <= 0 || D < 0 || (D > 0 && (!counts || !dom)))
    return cudaErrorInvalidValue;
  swap_apply_kernel<<<1, kApplyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(M), static_cast<int*>(G), static_cast<int*>(hist),
      static_cast<int*>(counts), static_cast<const int*>(dom),
      static_cast<long long*>(state), static_cast<const int*>(moves), P, p, v,
      D, cap);
  return static_cast<int>(cudaGetLastError());
}
