// Light-period window kernel for Hopper (sm_90a).
//
// Replaces traffic_env_tpu/ops/pallas_window.py:97 make_window_kernel
// (inner `kernel` :161-677, launched by `window` :680-749): W simulator
// ticks of one light period for a batch of envs, with the Repeater's
// window sums.  It covers every variant of the TPU kernel: spawns from
// schedule rows, from the in-kernel Poisson renewal chain with its
// backlog, or in regular batches (:391-399); the lazy autoreset; validate
// mode's trip telemetry (emit_trips, :244-250, :559-578, host scatter
// :853-862); the decel_penalty shaping (:521-537); and tables of k > 1
// car archetypes (the per-car index plane "ai", :123-147 and the
// multi branches after it).  Its plain PyTorch version is
// traffic_env_tpu_torch/ops/window.py:window_reference; the two agree
// bit for bit.
//
// Variants: telemetry (EMIT), decel_penalty (DECEL) and k > 1 (MULTI)
// are template flags, so the k = 1 training launch compiles none of
// their code.  The spawn mode (schedule, Poisson, regular) is a run-time
// value, the same for every thread.
//
// Design: one block per group of G consecutive envs (G and the thread
// count come from ops/window_cuda.py:geometry, a function of the road
// network and the variant; the word offsets of the block's shared arrays
// from its `layout`, passed in WindowArgs.L).  The block copies its
// envs' car planes and integer state from device memory into shared
// memory once, runs all W ticks there, and writes them back once.
// Shared arrays keep the env index fastest: a car plane is
// [slot][road][env] with each slot's row padded to a multiple of 32
// words, a per-road array [road][env], so
// the 32 threads of a warp, which hold 32 consecutive (road, env)
// items, touch 32 distinct banks whatever ring slot each env is at.
// The global layout (road, slot, env) keeps the G envs of one (road,
// slot) contiguous, so the copies are coalesced.  A tick is a sequence
// of phases separated by __syncthreads(), each spread over the block's
// threads by item (road, intersection or entry road, and env):
//   (a) phase/elapsed per intersection; the tick's Philox draws per
//       (slot, env); each entry road's spawn floor and free capacity;
//   (b) spawning, one thread per env (a serial chain of at most Ks
//       placements and the renewal chain);
//   (c) fake leaders per train road;
//   (d) the IDM per road, serial over its cars, waiting/detected and the
//       decel count;
//   (e1) every road's crossing count, and the crossing cars of every
//       train road copied to a staging area;
//   (e2) per road: pops, then the accepts, which read the feeder's
//       crossing cars from the staging area; the per-road overflow count;
//   (f) rewards per intersection, in the order the bit contract fixes;
//   (g) per env: steps, global tick, done.
// A done env's items skip their work; every thread reaches every
// barrier (no barrier sits inside a per-item branch or loop).  With a
// `clocks` array, thread 0 of each block adds the cycles of each phase,
// barrier to barrier, to clocks[phase] (the kernel's phase profile).
//
// Order of additions: decel_penalty makes rewards non-dyadic (count /
// 10), so the order of every addition to a reward is part of the bit
// contract.  Phase (f) starts from the spawn overflow penalties (added
// in placement order by the env's spawn thread), adds the decel terms of
// the intersection's train roads in ascending road order (the TPU
// kernel's direction-block order) as true divisions by a run-time 10,
// then the hand-off's overflow penalties: with DECEL summed first and
// added once (the TPU kernel's one-hot product), without it one by one.
// Those penalties are multiples of 10 and exact in any order.
//
// Telemetry: each exit-road pop adds 1 to its trip-time bin of
// trip_hist in device memory with an integer atomicAdd (several road
// threads of one env may hit one bin; integer adds are exact in any
// order).  No event plane, as the TPU kernel's host scatter needed.
//
// Bound: the least work is the car slots a window occupies (a few KB an
// env) read and written once, which chip_smoke.py counts as bound_ms.
// This design moves every env's whole rings (R x 19 slots x 12 or 16 B)
// in and out once a window, 3x that on the bench state: its own floor.
// Within the window the time is the latency of each road's serial chain
// of cars through shared memory and of the per-env spawn chain, hidden
// as far as the resident blocks (shared memory per env sets how many)
// can hide it.
//
// Float discipline: built with -fmad=false (no FMA contraction) and
// without fast math; pow(., 4) is two squarings, (x - l) - s0 rounds
// twice, the IDM denominator is scaled by a run-time 1.0, rounding is
// half to even (rintf), and logf is the accurate libdevice logf that
// torch.log runs on a CUDA tensor.

#include <cuda_runtime.h>
#include <stdint.h>

#define RING 19
#define MAX_K 8
#define MAX_IN 4          // train roads into one intersection
#define MAX_THREADS 1024
#define SMEM_MAX 232448   // dynamic shared memory a block may use on sm_90

// phases of the profile (WindowArgs.clocks)
enum { P_STAGE, P_DRAWS, P_SPAWN, P_LIGHTS, P_IDM, P_CROSS, P_HANDOFF,
       P_REWARD, P_COMMIT, P_STORE, NPHASE };

// columns of the archetype table (ops/window_cuda.py ARCH_COLUMNS)
enum { AX, AV, AL, AS0, AA, AB, AT, AV0, NCOL };

// spawn_mode
enum { SPAWN_SCHEDULE = 0, SPAWN_POISSON = 1, SPAWN_REGULAR = 2 };

// Word offsets of the shared arrays of one block, as ops/window_cuda.py
// `layout` computes them; the kernel takes them as they are.
struct Layout {
  int SS;  // words of one ring slot of a car plane: R * G padded to 32
  int x, v, w, ai;                                  // RING x SS each
  int ld, lc, cnt;                                  // R x G
  int phase, elapsed, pdst, act, rsum, lrew, spen;  // I x G
  int waiting, detected, accp, lastp, nover, dcnt;  // Rt x G
  // spawn scratch, phases (a)-(b): E x G, E x G, E x G, ndraw x G
  int floor_e, free_e, placed, bits;
  // hand-off staging, phases (e1)-(e2): Kc x Rt x G each
  int stage_x, stage_v, stage_w, stage_a;
  int done, steps, gtick, gap, backlog, seed, ovf;  // G each
  int ndraw;  // Philox draws of one tick and env
  int words;  // the block's dynamic shared memory in 32-bit words
};

struct WindowArgs {
  float* x;
  float* v;
  float* w;
  int* leading;
  int* lastcar;
  int* phase;
  int* elapsed;
  int* waiting;
  int* detected;
  unsigned char* passed_dst;
  int* gap;
  int* backlog;
  int* steps;
  int* gtick;
  unsigned char* done;
  const int* seed;
  const int* action;
  const int* spawn_rows;  // (W, Ks, B) entry indices; null in device mode
  int* acc_passed;
  float* rew_sum;
  float* last_rew;
  int* last_passed;
  int* trip_hist;  // (nb, B) validate mode only
  float* light;    // (I, B) validate mode only
  float* ai;       // (R, RING, B) archetype index per car, k > 1 only
  const int* spawn_ai;  // (W, Ks, B) archetype rows, k > 1 schedule mode
  const float* arch;    // (k, NCOL) archetype table, k > 1 only
  const int* nxt;
  const int* prev;
  const int* dest;
  const int* phase_group;
  const int* entry;
  const int* in_roads;  // (I, MAX_IN) train roads into each intersection,
                        // ascending, -1 past the last
  unsigned long long* clocks;  // (NPHASE,) phase profile, or null
  long long car_rstride;  // elements from one road's plane to the next
  int B, R, Rt, I, W, Ks, Kc, E;
  int n_renew, slot_first, slot_renew, slot_entry, slot_phase, slot_arch;
  int autoreset, spawn_mode, learn_switch, yellow, emit_trips, nb;
  int decel, k_arch, reg_tpc, reg_batch;
  int G;  // envs per block
  float length, rate, lam, detect_x, thresh, eps, penalty;
  float c_a, c_t, c_s0, c_l, c_v0, spawn_v, spawn_x, den0;
  Layout L;  // the block's shared memory
};

__device__ __forceinline__ float nn(float p) { return p < 0.0f ? 0.0f : p; }

__device__ __forceinline__ float fin(float p) {
  const float fmax = 3.402823466e+38f;
  return p > fmax ? fmax : (p < -fmax ? -fmax : p);
}

__device__ __forceinline__ float fmin_(float a, float b) {
  return b < a ? b : a;
}

// a % RING for a in [-RING, 2 * RING): conditional folds.
__device__ __forceinline__ int mod_s(int a) {
  a = a < 0 ? a + RING : a;
  return a >= RING ? a - RING : a;
}

// Word 0 of Philox4x32-10 with counter (c0, c1, 0, 0) and key (k0, k1).
__device__ __forceinline__ uint32_t philox_w0(uint32_t c0, uint32_t c1,
                                              uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ int gap_draw(float u, float lam) {
  return (int)rintf(-logf(u + 1e-12f) * lam);
}

// Schedule-mode lazy-reset phase: int32 Weyl/Knuth mix, logical shifts.
__device__ __forceinline__ int hash_phase(int gtick, int i) {
  uint32_t h = ((uint32_t)gtick + 1u) * 2654435761u + (uint32_t)i * 40503u;
  h ^= h >> 13;
  return (int)((h >> 14) & 1u);
}

// The archetype of an index read from the float plane: the TPU kernel's
// one-hot where-chain, so an index outside 1..k-1 reads row 0.
__device__ __forceinline__ int arch_of(float f, int k) {
  int j = 0;
  for (int q = 1; q < k; ++q) j = f == (float)q ? q : j;
  return j;
}

// The Philox counter slot of draw q of a tick (rows of the bits array).
__device__ __forceinline__ int draw_slot(const WindowArgs& a, int q) {
  if (q == 0) return a.slot_first;
  if (q <= a.n_renew) return a.slot_renew + q - 1;
  if (q <= a.n_renew + a.Ks) return a.slot_entry + q - 1 - a.n_renew;
  return a.slot_arch + q - 1 - a.n_renew - a.Ks;
}

// Whether the lazy autoreset restarts env b in this window.
__device__ __forceinline__ bool restarts(const WindowArgs& a, int b) {
  return a.autoreset && a.done[b];
}

// Cars at the front of the road of item `it` past its end, in order, at
// most Kc.
__device__ __forceinline__ int crossing(const WindowArgs& a, const float* X,
                                        int SS, int it, int ld, int lc) {
  const int n = mod_s(lc - ld);
  const int kmax = n < a.Kc ? n : a.Kc;
  int c = 0;
  for (int k = 1; k <= kmax; ++k) {
    if (!(X[mod_s(ld + k) * SS + it] > a.length)) break;
    ++c;
  }
  return c;
}

template <bool EMIT, bool DECEL, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS)
    window_kernel(const WindowArgs a) {
  extern __shared__ int sm[];
  const Layout L = a.L;
  const int G = a.G, B = a.B, R = a.R, Rt = a.Rt, I = a.I, E = a.E;
  const int SS = L.SS, RG = R * G, TG = Rt * G;
  const int b0 = blockIdx.x * G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long rs = a.car_rstride;
  const float INF = __int_as_float(0x7f800000);
  float* X = (float*)(sm + L.x);
  float* V = (float*)(sm + L.v);
  float* Wc = (float*)(sm + L.w);
  float* AI = (float*)(sm + L.ai);
  int* LD = sm + L.ld;
  int* LC = sm + L.lc;
  int* CNT = sm + L.cnt;
  int* PH = sm + L.phase;
  int* EL = sm + L.elapsed;
  int* PD = sm + L.pdst;
  int* ACT = sm + L.act;
  float* RSUM = (float*)(sm + L.rsum);
  float* LREW = (float*)(sm + L.lrew);
  float* SPEN = (float*)(sm + L.spen);
  int* WAIT = sm + L.waiting;
  int* DET = sm + L.detected;
  int* ACCP = sm + L.accp;
  int* LASTP = sm + L.lastp;
  int* NOVER = sm + L.nover;
  int* DCNT = sm + L.dcnt;
  float* FLOOR = (float*)(sm + L.floor_e);
  int* FREE = sm + L.free_e;
  int* PLACED = sm + L.placed;
  uint32_t* BITS = (uint32_t*)(sm + L.bits);
  float* SX = (float*)(sm + L.stage_x);  // [k][train road][env]
  float* SV = (float*)(sm + L.stage_v);
  float* SW = (float*)(sm + L.stage_w);
  float* SA = (float*)(sm + L.stage_a);
  int* DONE = sm + L.done;
  int* STEPS = sm + L.steps;
  int* GTICK = sm + L.gtick;
  int* GAP = sm + L.gap;
  int* BACKLOG = sm + L.backlog;
  int* SEED = sm + L.seed;
  int* OVF = sm + L.ovf;
  const int ndraw = L.ndraw;
#define PAR(j, col) a.arch[(j) * NCOL + (col)]
// items (row, env) of an n x G shared array, env fastest; a body may
// `continue` but holds no barrier
#define ITEMS(n) for (int it = tid; it < (n) * G; it += nt)
#define ONE(g) (STEPS[g] >= 0 ? 1.0f : 2.0f)  // run-time 1.0
  long long t_last = a.clocks && tid == 0 ? clock64() : 0;
// the barrier that ends phase p
#define SYNC(p)                                                    \
  __syncthreads();                                                 \
  if (a.clocks && tid == 0) {                                      \
    const long long t_now = clock64();                             \
    atomicAdd(&a.clocks[p], (unsigned long long)(t_now - t_last)); \
    t_last = t_now;                                                \
  }

  // -- stage the group's state, with the lazy reset ----------------------
  for (int it = tid; it < RING * RG; it += nt) {
    const int s = it / RG, rg = it - s * RG, g = rg % G, r = rg / G;
    const int b = b0 + g;
    if (b >= B) continue;
    const int q = s * SS + rg;
    if (s == 0 && restarts(a, b)) {
      X[q] = INF;
      V[q] = 0.0f;
      Wc[q] = 0.0f;
      if constexpr (MULTI) AI[q] = 0.0f;
    } else {
      const long long o = r * rs + (long long)s * B + b;
      X[q] = a.x[o];
      V[q] = a.v[o];
      Wc[q] = a.w[o];
      if constexpr (MULTI) AI[q] = a.ai[o];
    }
  }
  ITEMS(R) {
    const int g = it % G, r = it / G, b = b0 + g;
    if (b >= B) continue;
    const bool rst = restarts(a, b);
    LD[it] = rst ? 0 : a.leading[r * B + b];
    LC[it] = rst ? 0 : a.lastcar[r * B + b];
  }
  ITEMS(Rt) {
    const int g = it % G, t = it / G, b = b0 + g;
    ACCP[it] = 0;
    LASTP[it] = 0;
    if (b >= B) continue;
    WAIT[it] = restarts(a, b) ? 0 : a.waiting[t * B + b];
    DET[it] = a.detected[t * B + b];
  }
  ITEMS(I) {
    const int g = it % G, i = it / G, b = b0 + g;
    RSUM[it] = 0.0f;
    LREW[it] = 0.0f;
    if (b >= B) continue;
    const bool rst = restarts(a, b);
    const int ac = a.action[i * B + b];
    const int gt = a.gtick[b];
    int ph = a.phase[i * B + b];
    if (rst)
      ph = a.spawn_mode != SPAWN_SCHEDULE
               ? (int)(philox_w0((uint32_t)gt, (uint32_t)(a.slot_phase + i),
                                 (uint32_t)a.seed[b], (uint32_t)b) & 1u)
               : hash_phase(gt, i);
    const int el = rst ? 0 : a.elapsed[i * B + b];
    ACT[it] = ac;
    PH[it] = ph;
    EL[it] = el;
    PD[it] = rst ? 0 : a.passed_dst[i * B + b];
    if constexpr (EMIT) {
      // after the lazy reset: restarted lanes report their new phase
      a.light[i * B + b] = (float)((el + 1) * (ph != ac)) * 0.5f;
    }
  }
  if (tid < G) {
    const int g = tid, b = b0 + g;
    if (b < B) {
      const bool rst = restarts(a, b);
      DONE[g] = rst ? 0 : a.done[b];
      STEPS[g] = rst ? 0 : a.steps[b];
      GTICK[g] = a.gtick[b];
      GAP[g] = a.gap[b];
      BACKLOG[g] = a.backlog[b];
      SEED[g] = a.seed[b];
    } else {  // past the batch: every item skips
      DONE[g] = 1;
      STEPS[g] = GTICK[g] = GAP[g] = BACKLOG[g] = SEED[g] = 0;
    }
  }
  SYNC(P_STAGE);

  for (int tick = 0; tick < a.W; ++tick) {
    // -- (a) phase / elapsed; the tick's draws; entry roads' floors ------
    if (tid < G) OVF[tid] = 0;
    ITEMS(I) {
      const int g = it % G;
      SPEN[it] = 0.0f;
      if (DONE[g]) continue;
      const int ph = PH[it], ac = ACT[it];
      const int flip = (ph != 0) != (ac != 0);
      const int change = a.learn_switch ? ac : flip;
      PH[it] = a.learn_switch ? flip : ac;
      EL[it] = change == 0 ? EL[it] + 1 : 0;
    }
    ITEMS(ndraw) {
      // done lanes too: a lane's first gap is drawn even while it is done
      const int g = it % G, q = it / G, b = b0 + g;
      if (b >= B) continue;
      BITS[it] = philox_w0((uint32_t)GTICK[g], (uint32_t)draw_slot(a, q),
                           (uint32_t)SEED[g], (uint32_t)b);
    }
    ITEMS(E) {
      const int g = it % G, e = it / G;
      if (DONE[g]) continue;
      const int ri = a.entry[e] * G + g;
      const int ld = LD[ri], lc = LC[ri];
      float fl = INF;
      if (mod_s(lc - ld) > 0) {
        const int q = lc * SS + ri;
        if constexpr (MULTI) {
          // the tail car's own length and gap
          const int ta = arch_of(AI[q], a.k_arch);
          fl = (X[q] - PAR(ta, AL)) - PAR(ta, AS0);
        } else {
          fl = (X[q] - a.c_l * ONE(g)) - a.c_s0;
        }
      }
      FLOOR[it] = fl;
      FREE[it] = mod_s(ld - 1 - lc);
      PLACED[it] = 0;
    }
    SYNC(P_DRAWS);

    // -- (b) spawning: one thread per env --------------------------------
    if (tid < G) {
      const int g = tid, b = b0 + g;
      int gap = GAP[g], backlog = BACKLOG[g];
      if (b < B && a.spawn_mode == SPAWN_POISSON && gap < 0)
        gap = gap_draw(uniform24(BITS[g]), a.lam);
      if (!DONE[g]) {
        const float one = ONE(g);
        int nplace = 0;
        if (a.spawn_mode == SPAWN_REGULAR) {
          // a batch of reg_batch cars whenever the global tick hits the
          // interval; gap and backlog stay untouched
          const int due = a.reg_tpc ? GTICK[g] % a.reg_tpc == 0 : 1;
          nplace = due ? a.reg_batch : 0;
        } else if (a.spawn_mode == SPAWN_POISSON) {
          for (int k = 0; k < a.n_renew; ++k) {
            if (gap == 0) {
              ++backlog;
              gap = gap_draw(uniform24(BITS[(1 + k) * G + g]), a.lam);
            }
          }
          if (gap > 0) --gap;
          nplace = backlog < a.Ks ? backlog : a.Ks;
          backlog -= nplace;
        }
        for (int j = 0; j < a.Ks; ++j) {
          int e, aj = 0;
          if (a.spawn_mode != SPAWN_SCHEDULE) {
            if (j >= nplace) break;
            const float u = uniform24(BITS[(1 + a.n_renew + j) * G + g]);
            e = (int)(u * (float)E);
            e = e < E - 1 ? e : E - 1;
            if constexpr (MULTI) {
              // a Poisson arrival draws its archetype; regular ones are 0
              if (a.spawn_mode == SPAWN_POISSON) {
                const float ua =
                    uniform24(BITS[(1 + a.n_renew + a.Ks + j) * G + g]);
                aj = (int)(ua * (float)a.k_arch);
                aj = aj < a.k_arch - 1 ? aj : a.k_arch - 1;
              }
            }
          } else {
            e = a.spawn_rows[(tick * a.Ks + j) * B + b];
            if (e < 0) continue;
            if constexpr (MULTI) aj = a.spawn_ai[(tick * a.Ks + j) * B + b];
          }
          const int road = a.entry[e], ri = road * G + g, ei = e * G + g;
          if (PLACED[ei] >= FREE[ei]) {
            OVF[g] = 1;
            const int ii = a.dest[road] * G + g;
            SPEN[ii] = SPEN[ii] + (-a.penalty);
            continue;
          }
          const int p = ++PLACED[ei];
          const int q = mod_s(LC[ri] + p) * SS + ri;
          if constexpr (MULTI) {
            const int ap = aj > 0 && aj < a.k_arch ? aj : 0;
            const float xj = fmin_(PAR(ap, AX), FLOOR[ei]);
            FLOOR[ei] = (xj - PAR(ap, AL)) - PAR(ap, AS0);
            X[q] = xj;
            V[q] = PAR(ap, AV);
            AI[q] = (float)aj;
          } else {
            const float xj = fmin_(a.spawn_x, FLOOR[ei]);
            FLOOR[ei] = (xj - a.c_l * one) - a.c_s0;
            X[q] = xj;
            V[q] = a.spawn_v;
          }
          Wc[q] = (float)STEPS[g];
        }
        for (int e = 0; e < E; ++e) {
          const int ri = a.entry[e] * G + g;
          LC[ri] = mod_s(LC[ri] + PLACED[e * G + g]);
        }
      }
      GAP[g] = gap;
      BACKLOG[g] = backlog;
    }
    SYNC(P_SPAWN);

    // -- (c) lights: the fake leader of every train road ------------------
    ITEMS(Rt) {
      const int g = it % G, t = it / G;
      if (DONE[g]) continue;
      const int ii = a.dest[t] * G + g;
      const int red = (a.phase_group[t] == PH[ii]) || (EL[ii] < a.yellow);
      float fx = a.length;
      if (!red) {
        const int ni = a.nxt[t] * G + g;
        const int nl = LD[ni], nc = LC[ni];
        fx = nl == nc ? INF : X[nc * SS + ni] + a.length;
      }
      X[LD[it] * SS + it] = fx;
    }
    SYNC(P_LIGHTS);

    // -- (d) IDM, waiting / detected, decel count: per road ---------------
    ITEMS(R) {
      const int g = it % G, r = it / G;
      if (DONE[g]) continue;
      const float one = ONE(g);
      const float den = a.den0 * one;
      const float v0p = a.c_v0 * one;
      const int ld = LD[it], lc = LC[it];
      const int n = mod_s(lc - ld);
      const int wrapped = ld > lc;
      float lx = X[ld * SS + it], lv = V[ld * SS + it];
      float ll = 0.0f;  // MULTI: the leader's length; the fake leader has 0
      int wait_inc = 0, det = 0, decel = 0;
      for (int k = 1; k <= n; ++k) {
        const int s = mod_s(ld + k);
        const int q = s * SS + it;
        const float xs = X[q], vs = V[q];
        float dv;
        if constexpr (MULTI) {
          const int j = arch_of(AI[q], a.k_arch);
          const float pa = PAR(j, AA), pb = PAR(j, AB);
          const float dn = (2.0f * sqrtf(pa * pb)) * one;
          const float desired =
              PAR(j, AS0) + nn(nn(vs * PAR(j, AT)) + (vs * (vs - lv)) / dn);
          const float gapp = (lx - xs) - ll;
          const float qq = vs / (PAR(j, AV0) * one);
          const float q2 = qq * qq;
          const float free_flow = nn(q2 * q2);
          const float rr = desired / (gapp + a.eps);
          dv = pa * ((1.0f - free_flow) - nn(rr * rr));
          ll = PAR(j, AL);
        } else {
          const float ldl = k == 1 ? 0.0f : a.c_l;
          const float desired =
              a.c_s0 + nn(nn(vs * a.c_t) + (vs * (vs - lv)) / den);
          const float gapp = (lx - xs) - ldl;
          const float qq = vs / v0p;
          const float q2 = qq * qq;
          const float free_flow = nn(q2 * q2);
          const float rr = desired / (gapp + a.eps);
          dv = a.c_a * ((1.0f - free_flow) - nn(rr * rr));
        }
        const float dvr = dv * a.rate;
        if constexpr (DECEL) decel += dvr < 0.0f;
        const float dxp = nn(a.rate * vs) + fin((0.5f * dvr) * a.rate);
        const float xn = xs + nn((dxp > 0.0f ? 1.0f : 0.0f) * dxp);
        const float vn = nn(vs + fin(dvr));
        X[q] = xn;
        V[q] = vn;
        lx = xs;
        lv = vs;
        const float metric = (wrapped && s <= lc) ? xn : vn;
        wait_inc += metric < a.thresh;
        det += xn > a.detect_x;
      }
      if (r < Rt) {
        if (n > 0) {
          WAIT[it] += wait_inc;
          DET[it] = det;
        }
        if constexpr (DECEL) DCNT[it] = decel;
      }
    }
    SYNC(P_IDM);

    // -- (e1) crossing counts; train roads' crossing cars to the stage ----
    ITEMS(R) {
      const int g = it % G, r = it / G;
      if (DONE[g]) continue;
      const int ld = LD[it];
      const int c = crossing(a, X, SS, it, ld, LC[it]);
      CNT[it] = c;
      if (r < Rt) {
        for (int k = 0; k < c; ++k) {
          const int q = mod_s(ld + 1 + k) * SS + it, si = k * TG + it;
          SX[si] = X[q];
          SV[si] = V[q];
          SW[si] = Wc[q];
          if constexpr (MULTI) SA[si] = AI[q];
        }
      }
    }
    SYNC(P_CROSS);

    // -- (e2) per road: pops, then accepts from the feeder's stage --------
    ITEMS(R) {
      const int g = it % G, f = it / G, b = b0 + g;
      if (DONE[g]) continue;
      const float one = ONE(g);
      const int ldf = LD[it], lcf = LC[it], cnt = CNT[it];
      const int qf = ldf * SS + it;
      const float fx = X[qf], fv = V[qf], fw = Wc[qf];
      const float fa = MULTI ? AI[qf] : 0.0f;
      // the receiver's tail, read before its own pops
      const float tail = X[lcf * SS + it];
      const float tail_a = MULTI ? AI[lcf * SS + it] : 0.0f;
      if constexpr (EMIT) {
        if (f >= Rt) {  // an exit road: its crossing cars leave the map
          for (int k = 1; k <= cnt; ++k) {
            const float wk = Wc[mod_s(ldf + k) * SS + it];
            // clamp before the cast: casting +-inf to int is undefined
            const int dur = STEPS[g] - (int)(wk < 0.0f ? 0.0f
                                             : (wk > 1e9f ? 1e9f : wk));
            const int bin = dur < 0 ? 0 : (dur > a.nb - 1 ? a.nb - 1 : dur);
            atomicAdd(&a.trip_hist[(long long)bin * B + b], 1);
          }
        }
      }
      for (int k = 1; k <= cnt; ++k) {
        const int q = mod_s(ldf + k) * SS + it;
        X[q] = fx;
        V[q] = fv;
        Wc[q] = fw;
        if constexpr (MULTI) AI[q] = fa;
      }
      const int new_ld = mod_s(ldf + cnt);
      const int p = a.prev[f];
      const int pi = p * G + g;
      const int cnt_in = p >= 0 && p < Rt ? CNT[pi] : 0;
      const int ff = p >= 0 && p < f;  // feeder handed off first
      const int free2 = mod_s((ff ? ldf : new_ld) - 1 - lcf);
      const int acc = cnt_in < free2 ? cnt_in : free2;
      if (cnt_in > acc) OVF[g] = 1;
      if (f < Rt) NOVER[it] = cnt_in - acc;
      const int occ = ff ? (ldf != lcf) : (new_ld != lcf);
      float floor2 = INF;
      if (occ) {
        if constexpr (MULTI) {
          const int ta = arch_of(tail_a, a.k_arch);
          floor2 = (tail - PAR(ta, AL)) - PAR(ta, AS0);
        } else {
          floor2 = (tail - a.c_l * one) - a.c_s0;
        }
      }
      for (int k = 0; k < acc; ++k) {
        const int si = k * TG + pi, sd = mod_s(lcf + 1 + k) * SS + it;
        const float xin = fmin_(SX[si] - a.length, floor2);
        X[sd] = xin;
        V[sd] = SV[si];
        Wc[sd] = SW[si];
        if constexpr (MULTI) {
          // each accepted car becomes the tail: its own length and gap
          // chain the next floor
          const float ain = SA[si];
          AI[sd] = ain;
          const int ja = arch_of(ain, a.k_arch);
          floor2 = (xin - PAR(ja, AL)) - PAR(ja, AS0);
        } else {
          floor2 = (xin - a.c_l * one) - a.c_s0;
        }
      }
      LD[it] = new_ld;
      LC[it] = mod_s(lcf + acc);
      if (f < Rt) {
        ACCP[it] += cnt;
        LASTP[it] = cnt;
        if (cnt > 0) PD[a.dest[f] * G + g] = 1;
      }
    }
    SYNC(P_HANDOFF);

    // -- (f) rewards per intersection -------------------------------------
    ITEMS(I) {
      const int g = it % G, i = it / G;
      if (DONE[g]) continue;
      const float one = ONE(g);
      const int* in = a.in_roads + i * MAX_IN;
      float rew = SPEN[it];
      if constexpr (DECEL) {
        // a true division by a run-time 10, as the TPU kernel's
        for (int d = 0; d < MAX_IN; ++d)
          if (in[d] >= 0)
            rew = rew + (float)DCNT[in[d] * G + g] / (10.0f * one);
        float pen = 0.0f;
        for (int d = 0; d < MAX_IN; ++d) {
          const int n_over = in[d] >= 0 ? NOVER[in[d] * G + g] : 0;
          if (n_over > 0) pen = pen + -a.penalty * (float)n_over;
        }
        rew = rew + pen;
      } else {
        for (int d = 0; d < MAX_IN; ++d) {
          const int n_over = in[d] >= 0 ? NOVER[in[d] * G + g] : 0;
          if (n_over > 0) rew = rew + -a.penalty * (float)n_over;
        }
      }
      RSUM[it] = RSUM[it] + rew;
      LREW[it] = rew;
    }
    SYNC(P_REWARD);

    // -- (g) commit the tick: per env --------------------------------------
    if (tid < G && !DONE[tid]) {
      ++STEPS[tid];
      ++GTICK[tid];
      DONE[tid] = OVF[tid];
    }
    SYNC(P_COMMIT);
  }

  // -- write the group's state back ---------------------------------------
  for (int it = tid; it < RING * RG; it += nt) {
    const int s = it / RG, rg = it - s * RG, g = rg % G, r = rg / G;
    const int b = b0 + g;
    if (b >= B) continue;
    const int q = s * SS + rg;
    const long long o = r * rs + (long long)s * B + b;
    a.x[o] = X[q];
    a.v[o] = V[q];
    a.w[o] = Wc[q];
    if constexpr (MULTI) a.ai[o] = AI[q];
  }
  ITEMS(R) {
    const int g = it % G, r = it / G, b = b0 + g;
    if (b >= B) continue;
    a.leading[r * B + b] = LD[it];
    a.lastcar[r * B + b] = LC[it];
  }
  ITEMS(Rt) {
    const int g = it % G, t = it / G, b = b0 + g;
    if (b >= B) continue;
    a.waiting[t * B + b] = WAIT[it];
    a.detected[t * B + b] = DET[it];
    a.acc_passed[t * B + b] = ACCP[it];
    a.last_passed[t * B + b] = LASTP[it];
  }
  ITEMS(I) {
    const int g = it % G, i = it / G, b = b0 + g;
    if (b >= B) continue;
    a.phase[i * B + b] = PH[it];
    a.elapsed[i * B + b] = EL[it];
    a.passed_dst[i * B + b] = (unsigned char)PD[it];
    a.rew_sum[i * B + b] = RSUM[it];
    a.last_rew[i * B + b] = LREW[it];
  }
  if (tid < G && b0 + tid < B) {
    const int g = tid, b = b0 + g;
    a.done[b] = (unsigned char)DONE[g];
    a.steps[b] = STEPS[g];
    a.gtick[b] = GTICK[g];
    a.gap[b] = GAP[g];
    a.backlog[b] = BACKLOG[g];
  }
  if (a.clocks) {  // the same for every thread of the block
    SYNC(P_STORE);
  }
#undef PAR
#undef ITEMS
#undef ONE
#undef SYNC
}

typedef void (*WindowFn)(const WindowArgs);

// The instance for variant bits (emit | decel << 1 | multi << 2).
static WindowFn instance(int v) {
  switch (v) {
    case 0: return window_kernel<false, false, false>;
    case 1: return window_kernel<true, false, false>;
    case 2: return window_kernel<false, true, false>;
    case 3: return window_kernel<true, true, false>;
    case 4: return window_kernel<false, false, true>;
    case 5: return window_kernel<true, false, true>;
    case 6: return window_kernel<false, true, true>;
    default: return window_kernel<true, true, true>;
  }
}

static int variant_of(const WindowArgs& a) {
  return (a.emit_trips ? 1 : 0) | (a.decel ? 2 : 0) | (a.k_arch > 1 ? 4 : 0);
}

// Lets every instance take up to SMEM_MAX bytes of dynamic shared memory
// on the current device (the default is 48 KB), once per device.
static int prepare(void) {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  for (int v = 0; v < 8; ++v) {
    e = cudaFuncSetAttribute((const void*)instance(v),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute((const void*)instance(v),
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  done[dev] = true;
  return 0;
}

// Refuses arguments the kernel does not take: fewer threads than envs
// a block (the per-env phases run one thread per env), more than a
// block may have, or more shared memory than a block may use.
static int check(const WindowArgs& a, int threads) {
  if (a.k_arch < 1 || a.k_arch > MAX_K || a.G < 1 || a.Kc < 1 ||
      threads < a.G || threads > MAX_THREADS || a.L.words < 1 ||
      a.L.words > SMEM_MAX / 4)
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int window_launch(WindowArgs a, int threads, void* stream) {
  int rc = check(a, threads);
  if (rc) return rc;
  if ((rc = prepare())) return rc;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      (const void*)instance(variant_of(a)), dim3((a.B + a.G - 1) / a.G),
      dim3(threads), args, (size_t)a.L.words * 4, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the instance `a` selects at this geometry.
extern "C" int window_occupancy(WindowArgs a, int threads, int* blocks) {
  int rc = check(a, threads);
  if (rc) return rc;
  if ((rc = prepare())) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void*)instance(variant_of(a)), threads,
      (size_t)a.L.words * 4);
}
