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
// choice that is the same for every thread and lies outside the IDM
// loop.
//
// decel_penalty makes rewards non-dyadic (count / 10), so the order of
// every later addition is part of the bit contract: the decel terms are
// added per train road in ascending road order (for each intersection
// the TPU kernel's direction-block order), and the hand-off's overflow
// penalties are summed per intersection first (an exact multiple of 10)
// and added once, as the TPU kernel's one-hot matrix product does.
//
// Telemetry: the TPU kernel writes a (W*Kc, R, B) plane of exit-pop
// durations because Mosaic has no scatter, and the host scatters it into
// the trip histogram.  Here the thread that owns an env owns its column
// of trip_hist, so each exit-road pop adds 1 to its bin in place: no
// event plane, no atomics.  The telemetry is a template flag, compiled
// out of the training launch.
//
// Design: one thread per env runs the W-tick loop.  The state planes are
// read and written in place in device memory, indexed [..., b], so a
// warp's accesses to one (road, slot) are coalesced.  Permutations of
// the TPU kernel (one-hot matrix products) are index loads of nxt/prev;
// the hand-off is a loop over roads, each road after its successor, so
// a feeder's crossing cars are read before the feeder's own pops and
// pushes overwrite them.
//
// Bound: memory.  A window needs to read and write each env's occupied
// car slots (x, v, w, 12 B a slot) and one fake-leader slot per road,
// plus its integer planes, and does a few tens of float operations per
// car and tick; the car planes are streamed through L1/L2 every tick
// rather than held in registers or shared memory across the W ticks,
// which is the next step for speed.
//
// Float discipline: built with -fmad=false (no FMA contraction) and
// without fast math; pow(., 4) is two squarings, (x - l) - s0 rounds
// twice, the IDM denominator is scaled by a run-time 1.0, rounding is
// half to even (rintf), and logf is the accurate libdevice logf that
// torch.log runs on a CUDA tensor.

#include <cuda_runtime.h>
#include <stdint.h>

#define RING 19
#define MAX_E 64
#define MAX_I 64
#define MAX_K 8

// columns of the archetype table (ops/window_cuda.py ARCH_COLUMNS)
enum { AX, AV, AL, AS0, AA, AB, AT, AV0, NCOL };

// spawn_mode
enum { SPAWN_SCHEDULE = 0, SPAWN_POISSON = 1, SPAWN_REGULAR = 2 };

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
  const int* order;  // every road after its successor
  long long car_rstride;  // elements from one road's plane to the next
  int B, R, Rt, I, W, Ks, Kc, E;
  int n_renew, slot_first, slot_renew, slot_entry, slot_phase, slot_arch;
  int autoreset, spawn_mode, learn_switch, yellow, emit_trips, nb;
  int decel, k_arch, reg_tpc, reg_batch;
  float length, rate, lam, detect_x, thresh, eps, penalty;
  float c_a, c_t, c_s0, c_l, c_v0, spawn_v, spawn_x, den0;
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

// Cars at the front of road r past its end, in order, at most Kc.
__device__ __forceinline__ int crossing(const WindowArgs& a, const float* X,
                                        int r, int ld, int lc) {
  const int n = mod_s(lc - ld);
  const int kmax = n < a.Kc ? n : a.Kc;
  int c = 0;
  for (int k = 1; k <= kmax; ++k) {
    if (!(X[r * a.car_rstride + mod_s(ld + k) * (long long)a.B] > a.length))
      break;
    ++c;
  }
  return c;
}

template <bool EMIT, bool DECEL, bool MULTI>
__global__ void window_kernel(const WindowArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B;
  const long long rs = a.car_rstride;
  float* X = a.x + b;
  float* V = a.v + b;
  float* Wc = a.w + b;
  float* AI = MULTI ? a.ai + b : nullptr;
#define CAR(P, r, s) P[(long long)(r) * rs + (long long)(s) * B]
#define ROW(P, r) P[(r) * B + b]
#define PAR(j, col) a.arch[(j) * NCOL + (col)]
  const uint32_t key0 = (uint32_t)a.seed[b], key1 = (uint32_t)b;
  int done = a.done[b];
  int steps = a.steps[b], gtick = a.gtick[b];
  int gap = a.gap[b], backlog = a.backlog[b];

  if (a.autoreset && done) {
    for (int r = 0; r < a.R; ++r) {
      CAR(X, r, 0) = __int_as_float(0x7f800000);
      CAR(V, r, 0) = 0.0f;
      CAR(Wc, r, 0) = 0.0f;
      if constexpr (MULTI) CAR(AI, r, 0) = 0.0f;
      ROW(a.leading, r) = 0;
      ROW(a.lastcar, r) = 0;
    }
    for (int i = 0; i < a.I; ++i) {
      ROW(a.elapsed, i) = 0;
      ROW(a.passed_dst, i) = 0;
      ROW(a.phase, i) =
          a.spawn_mode != SPAWN_SCHEDULE
              ? (int)(philox_w0((uint32_t)gtick, (uint32_t)(a.slot_phase + i),
                                key0, key1) & 1u)
              : hash_phase(gtick, i);
    }
    for (int t = 0; t < a.Rt; ++t) ROW(a.waiting, t) = 0;
    steps = 0;
    done = 0;
  }
  if constexpr (EMIT) {
    // after the lazy reset: restarted lanes report their new phase
    for (int i = 0; i < a.I; ++i) {
      const int changed = ROW(a.phase, i) != a.action[i * B + b];
      ROW(a.light, i) = (float)((ROW(a.elapsed, i) + 1) * changed) * 0.5f;
    }
  }
  for (int t = 0; t < a.Rt; ++t) {
    ROW(a.acc_passed, t) = 0;
    ROW(a.last_passed, t) = 0;
  }
  for (int i = 0; i < a.I; ++i) {
    ROW(a.rew_sum, i) = 0.0f;
    ROW(a.last_rew, i) = 0.0f;
  }

  float rew[MAX_I];
  float pen[DECEL ? MAX_I : 1];  // the hand-off's penalties per intersection
  int placed[MAX_E], free_e[MAX_E];
  float floor_e[MAX_E];

  for (int tick = 0; tick < a.W; ++tick) {
    if (a.spawn_mode == SPAWN_POISSON && gap < 0)
      gap = gap_draw(uniform24(philox_w0((uint32_t)gtick,
                                         (uint32_t)a.slot_first, key0, key1)),
                     a.lam);
    if (done) continue;  // finished lanes stay frozen

    // -- phase / elapsed ------------------------------------------------
    for (int i = 0; i < a.I; ++i) {
      const int ph = ROW(a.phase, i), ac = a.action[i * B + b];
      const int flip = (ph != 0) != (ac != 0);
      const int change = a.learn_switch ? ac : flip;
      ROW(a.phase, i) = a.learn_switch ? flip : ac;
      ROW(a.elapsed, i) = change == 0 ? ROW(a.elapsed, i) + 1 : 0;
      rew[i] = 0.0f;
      if constexpr (DECEL) pen[i] = 0.0f;
    }
    const float one = steps >= 0 ? 1.0f : 2.0f;  // run-time 1.0
    int ovf = 0;

    // -- spawning -------------------------------------------------------
    for (int e = 0; e < a.E; ++e) {
      const int road = a.entry[e];
      const int ld = ROW(a.leading, road), lc = ROW(a.lastcar, road);
      float fl = __int_as_float(0x7f800000);
      if (mod_s(lc - ld) > 0) {
        if constexpr (MULTI) {
          // the tail car's own length and gap
          const int ta = arch_of(CAR(AI, road, lc), a.k_arch);
          fl = (CAR(X, road, lc) - PAR(ta, AL)) - PAR(ta, AS0);
        } else {
          fl = (CAR(X, road, lc) - a.c_l * one) - a.c_s0;
        }
      }
      floor_e[e] = fl;
      free_e[e] = mod_s(ld - 1 - lc);
      placed[e] = 0;
    }
    int nplace = 0;
    if (a.spawn_mode == SPAWN_REGULAR) {
      // a batch of reg_batch cars whenever the global tick hits the
      // interval; gap and backlog stay untouched
      const int due = a.reg_tpc ? gtick % a.reg_tpc == 0 : 1;
      nplace = due ? a.reg_batch : 0;
    } else if (a.spawn_mode == SPAWN_POISSON) {
      for (int k = 0; k < a.n_renew; ++k) {
        if (gap == 0) {
          ++backlog;
          gap = gap_draw(
              uniform24(philox_w0((uint32_t)gtick,
                                  (uint32_t)(a.slot_renew + k), key0, key1)),
              a.lam);
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
        const float u = uniform24(philox_w0(
            (uint32_t)gtick, (uint32_t)(a.slot_entry + j), key0, key1));
        e = (int)(u * (float)a.E);
        e = e < a.E - 1 ? e : a.E - 1;
        if constexpr (MULTI) {
          // a Poisson arrival draws its archetype; regular ones are 0
          if (a.spawn_mode == SPAWN_POISSON) {
            const float ua = uniform24(philox_w0(
                (uint32_t)gtick, (uint32_t)(a.slot_arch + j), key0, key1));
            aj = (int)(ua * (float)a.k_arch);
            aj = aj < a.k_arch - 1 ? aj : a.k_arch - 1;
          }
        }
      } else {
        e = a.spawn_rows[(tick * a.Ks + j) * B + b];
        if (e < 0) continue;
        if constexpr (MULTI) aj = a.spawn_ai[(tick * a.Ks + j) * B + b];
      }
      const int road = a.entry[e];
      if (placed[e] >= free_e[e]) {
        ovf = 1;
        const int i = a.dest[road];
        rew[i] = rew[i] + (-a.penalty);
        continue;
      }
      ++placed[e];
      const int s = mod_s(ROW(a.lastcar, road) + placed[e]);
      if constexpr (MULTI) {
        const int ap = aj > 0 && aj < a.k_arch ? aj : 0;
        const float xj = fmin_(PAR(ap, AX), floor_e[e]);
        floor_e[e] = (xj - PAR(ap, AL)) - PAR(ap, AS0);
        CAR(X, road, s) = xj;
        CAR(V, road, s) = PAR(ap, AV);
        CAR(AI, road, s) = (float)aj;
      } else {
        const float xj = fmin_(a.spawn_x, floor_e[e]);
        floor_e[e] = (xj - a.c_l * one) - a.c_s0;
        CAR(X, road, s) = xj;
        CAR(V, road, s) = a.spawn_v;
      }
      CAR(Wc, road, s) = (float)steps;
    }
    for (int e = 0; e < a.E; ++e) {
      const int road = a.entry[e];
      ROW(a.lastcar, road) = mod_s(ROW(a.lastcar, road) + placed[e]);
    }

    // -- lights: the fake leader of every train road ----------------------
    for (int t = 0; t < a.Rt; ++t) {
      const int i = a.dest[t];
      const int red = (a.phase_group[t] == ROW(a.phase, i)) ||
                      (ROW(a.elapsed, i) < a.yellow);
      float fx = a.length;
      if (!red) {
        const int nx = a.nxt[t];
        const int nl = ROW(a.leading, nx), nc = ROW(a.lastcar, nx);
        fx = nl == nc ? __int_as_float(0x7f800000) : CAR(X, nx, nc) + a.length;
      }
      CAR(X, t, ROW(a.leading, t)) = fx;
    }

    // -- IDM, waiting / detected -----------------------------------------
    const float den = a.den0 * one;
    const float v0p = a.c_v0 * one;
    for (int r = 0; r < a.R; ++r) {
      const int ld = ROW(a.leading, r), lc = ROW(a.lastcar, r);
      const int n = mod_s(lc - ld);
      const int wrapped = ld > lc;
      float lx = CAR(X, r, ld), lv = CAR(V, r, ld);
      float ll = 0.0f;  // MULTI: the leader's length; the fake leader has 0
      int wait_inc = 0, det = 0, decel = 0;
      for (int k = 1; k <= n; ++k) {
        const int s = mod_s(ld + k);
        const float xs = CAR(X, r, s), vs = CAR(V, r, s);
        float dv;
        if constexpr (MULTI) {
          const int j = arch_of(CAR(AI, r, s), a.k_arch);
          const float pa = PAR(j, AA), pb = PAR(j, AB);
          const float dn = (2.0f * sqrtf(pa * pb)) * one;
          const float desired =
              PAR(j, AS0) + nn(nn(vs * PAR(j, AT)) + (vs * (vs - lv)) / dn);
          const float gapp = (lx - xs) - ll;
          const float q = vs / (PAR(j, AV0) * one);
          const float q2 = q * q;
          const float free_flow = nn(q2 * q2);
          const float rr = desired / (gapp + a.eps);
          dv = pa * ((1.0f - free_flow) - nn(rr * rr));
          ll = PAR(j, AL);
        } else {
          const float ldl = k == 1 ? 0.0f : a.c_l;
          const float desired =
              a.c_s0 + nn(nn(vs * a.c_t) + (vs * (vs - lv)) / den);
          const float gapp = (lx - xs) - ldl;
          const float q = vs / v0p;
          const float q2 = q * q;
          const float free_flow = nn(q2 * q2);
          const float rr = desired / (gapp + a.eps);
          dv = a.c_a * ((1.0f - free_flow) - nn(rr * rr));
        }
        const float dvr = dv * a.rate;
        if constexpr (DECEL) decel += dvr < 0.0f;
        const float dxp = nn(a.rate * vs) + fin((0.5f * dvr) * a.rate);
        const float xn = xs + nn((dxp > 0.0f ? 1.0f : 0.0f) * dxp);
        const float vn = nn(vs + fin(dvr));
        CAR(X, r, s) = xn;
        CAR(V, r, s) = vn;
        lx = xs;
        lv = vs;
        const float metric = (wrapped && s <= lc) ? xn : vn;
        wait_inc += metric < a.thresh;
        det += xn > a.detect_x;
      }
      if (r < a.Rt && n > 0) {
        ROW(a.waiting, r) += wait_inc;
        ROW(a.detected, r) = det;
      }
      if constexpr (DECEL) {
        // a true division by a run-time 10, as the TPU kernel's
        if (r < a.Rt) {
          const int i = a.dest[r];
          rew[i] = rew[i] + (float)decel / (10.0f * one);
        }
      }
    }

    // -- hand-off, each road after its successor ---------------------------
    for (int oi = 0; oi < a.R; ++oi) {
      const int f = a.order[oi];
      const int ldf = ROW(a.leading, f), lcf = ROW(a.lastcar, f);
      const int cnt = crossing(a, X, f, ldf, lcf);
      const float fx = CAR(X, f, ldf), fv = CAR(V, f, ldf),
                  fw = CAR(Wc, f, ldf);
      const float fa = MULTI ? CAR(AI, f, ldf) : 0.0f;
      // the receiver's tail, read before its own pops
      const float tail = CAR(X, f, lcf);
      const float tail_a = MULTI ? CAR(AI, f, lcf) : 0.0f;
      if constexpr (EMIT) {
        if (f >= a.Rt) {  // an exit road: its crossing cars leave the map
          for (int k = 1; k <= cnt; ++k) {
            const float wk = CAR(Wc, f, mod_s(ldf + k));
            // clamp before the cast: casting +-inf to int is undefined
            const int dur = steps - (int)(wk < 0.0f ? 0.0f
                                          : (wk > 1e9f ? 1e9f : wk));
            const int bin = dur < 0 ? 0 : (dur > a.nb - 1 ? a.nb - 1 : dur);
            a.trip_hist[(long long)bin * B + b] += 1;
          }
        }
      }
      for (int k = 1; k <= cnt; ++k) {
        const int s = mod_s(ldf + k);
        CAR(X, f, s) = fx;
        CAR(V, f, s) = fv;
        CAR(Wc, f, s) = fw;
        if constexpr (MULTI) CAR(AI, f, s) = fa;
      }
      const int new_ld = mod_s(ldf + cnt);
      const int p = a.prev[f];
      int cnt_in = 0, ldp = 0;
      if (p >= 0 && p < a.Rt) {
        ldp = ROW(a.leading, p);
        cnt_in = crossing(a, X, p, ldp, ROW(a.lastcar, p));
      }
      const int ff = p >= 0 && p < f;  // feeder handed off first
      const int free2 = mod_s((ff ? ldf : new_ld) - 1 - lcf);
      const int acc = cnt_in < free2 ? cnt_in : free2;
      if (cnt_in > acc) {
        ovf = 1;
        if (f < a.Rt) {
          const int i = a.dest[f];
          const float dp = -a.penalty * (float)(cnt_in - acc);
          if constexpr (DECEL)
            pen[i] = pen[i] + dp;
          else
            rew[i] = rew[i] + dp;
        }
      }
      const int occ = ff ? (ldf != lcf) : (new_ld != lcf);
      float floor2 = __int_as_float(0x7f800000);
      if (occ) {
        if constexpr (MULTI) {
          const int ta = arch_of(tail_a, a.k_arch);
          floor2 = (tail - PAR(ta, AL)) - PAR(ta, AS0);
        } else {
          floor2 = (tail - a.c_l * one) - a.c_s0;
        }
      }
      for (int k = 0; k < acc; ++k) {
        const int ss = mod_s(ldp + 1 + k), sd = mod_s(lcf + 1 + k);
        const float xin = fmin_(CAR(X, p, ss) - a.length, floor2);
        CAR(X, f, sd) = xin;
        CAR(V, f, sd) = CAR(V, p, ss);
        CAR(Wc, f, sd) = CAR(Wc, p, ss);
        if constexpr (MULTI) {
          // each accepted car becomes the tail: its own length and gap
          // chain the next floor
          const float ain = CAR(AI, p, ss);
          CAR(AI, f, sd) = ain;
          const int ja = arch_of(ain, a.k_arch);
          floor2 = (xin - PAR(ja, AL)) - PAR(ja, AS0);
        } else {
          floor2 = (xin - a.c_l * one) - a.c_s0;
        }
      }
      ROW(a.leading, f) = new_ld;
      ROW(a.lastcar, f) = mod_s(lcf + acc);
      if (f < a.Rt) {
        ROW(a.acc_passed, f) += cnt;
        ROW(a.last_passed, f) = cnt;
        if (cnt > 0) ROW(a.passed_dst, a.dest[f]) = 1;
      }
    }

    if constexpr (DECEL) {
      for (int i = 0; i < a.I; ++i) rew[i] = rew[i] + pen[i];
    }

    // -- commit the tick ---------------------------------------------------
    ++steps;
    ++gtick;
    for (int i = 0; i < a.I; ++i) {
      ROW(a.rew_sum, i) = ROW(a.rew_sum, i) + rew[i];
      ROW(a.last_rew, i) = rew[i];
    }
    done = ovf;
  }
  a.done[b] = (unsigned char)done;
  a.steps[b] = steps;
  a.gtick[b] = gtick;
  a.gap[b] = gap;
  a.backlog[b] = backlog;
#undef CAR
#undef ROW
#undef PAR
}

extern "C" int window_launch(WindowArgs a, void* stream) {
  if (a.E > MAX_E || a.I > MAX_I || a.k_arch < 1 || a.k_arch > MAX_K)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (a.B + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  const int v = (a.emit_trips ? 1 : 0) | (a.decel ? 2 : 0) |
                (a.k_arch > 1 ? 4 : 0);
#define LAUNCH(E, D, M) window_kernel<E, D, M><<<blocks, threads, 0, st>>>(a)
  switch (v) {
    case 0: LAUNCH(false, false, false); break;
    case 1: LAUNCH(true, false, false); break;
    case 2: LAUNCH(false, true, false); break;
    case 3: LAUNCH(true, true, false); break;
    case 4: LAUNCH(false, false, true); break;
    case 5: LAUNCH(true, false, true); break;
    case 6: LAUNCH(false, true, true); break;
    default: LAUNCH(true, true, true); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
